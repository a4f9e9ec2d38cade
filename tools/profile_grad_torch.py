"""Where the time of one differentiable step goes, on the GPU.

One forward+backward step of the L2 loss through
``driver.optimize.render_differentiable`` (Cornell, every scene and camera
leaf trains) under torch.profiler: the operators sorted by their own
device time, with their call counts, and the card's busy time against the
step's wall time.

Usage: python tools/profile_grad_torch.py [--size 512] [--spp 2] [--soft 0]
       [--top 25] [--no-kernel]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--soft", type=float, default=0.0)
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--no-kernel", action="store_true", help="plain forward too")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver import optimize as O
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    spec = get_scene(args.scene)
    scene, camera = spec.to_scene(), spec.to_camera()
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp, seed=0,
                       soft_edges=args.soft, use_kernel=not args.no_kernel)
    with torch.no_grad():
        target = O.render_differentiable(scene, camera, cfg) * 0.9
    leaves = {k: getattr(scene if k in O.SCENE_LEAVES else camera, k).detach().clone()
              .requires_grad_(True) for k in O.LEAVES}
    s, c = O.merge(scene, camera, leaves)

    def step():
        for t in leaves.values():
            t.grad = None
        torch.mean((O.render_differentiable(s, c, cfg) - target) ** 2).backward()

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # The card's own events (kernels, copies) give its busy time; the host
    # operators that launched them carry the same time, and list it by name.
    events = prof.key_averages()
    busy = sum(dev(e) for e in events if e.device_type.name != "CPU") / 1e3
    ops = sorted((e for e in events if e.device_type.name == "CPU"), key=dev, reverse=True)
    print(f"{args.scene} {args.size}x{args.size} spp {args.spp} soft {args.soft} "
          f"kernel forward {not args.no_kernel}: step {wall:.3f} ms (unprofiled), card busy "
          f"{busy:.3f} ms under the profiler, idle share {max(0.0, 1 - busy / wall):.2%}")
    print(f"{'self device ms':>15} {'share':>7} {'calls':>7}  operator")
    for e in ops[:args.top]:
        print(f"{dev(e) / 1e3:15.3f} {dev(e) / 1e3 / busy:7.2%} {e.count:7d}  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
