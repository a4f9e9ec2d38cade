"""Inverse rendering demo in the PyTorch port (twin of
examples/inverse_rendering.py, BASELINE.json config #4).

Recovers a moved ceiling light and a tinted left wall of the Cornell box
from a target image using pixel gradients (the differentiable version of
the reference's interactive keystroke edit loop, SURVEY.md §3.5), through
``driver/optimize.run_inverse_rendering``.

    python examples/inverse_rendering_torch.py [--size 128] [--steps 60] [--spp 2]
        [--kernel/--no-kernel] [--soft W] [--device cuda|cpu]

``--kernel`` (the JAX example's ``--pallas``) runs the forward in the
hand-written kernel (K1) and, on a GPU, the backward in K1b (on the CPU the
VJP of the plain path recomputed from the same seeds); by default it is on
when the device is a GPU. The default device is the CUDA device; ``--device cpu`` runs on the
CPU. Prints the loss curve and the final parameter errors; writes
before/after/target images to ``--outdir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.15)
    ap.add_argument(
        "--kernel", action=argparse.BooleanOptionalAction, default=None,
        help="forward on the hand-written kernel, backward = the plain path's VJP "
        "(default: on when the device is a GPU). Run at --size 512 for BASELINE "
        "config #4 full scale (see tools/grad_bench_torch.py).",
    )
    ap.add_argument("--outdir", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument(
        "--soft", type=float, default=0.0,
        help="differentiable-visibility relaxation width (world units): > 0 gives "
        "the optimizer silhouette gradients; forces the plain path.",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; cpu only when asked)")
    args = ap.parse_args(argv)

    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.core.types import resolve_device
    from se195_raytracer_tpu_torch.driver.optimize import (
        l2_image_loss,
        render_differentiable,
        run_inverse_rendering,
    )
    from se195_raytracer_tpu_torch.io.image import write_png
    from se195_raytracer_tpu_torch.ops.tonemap import to_srgb_bytes
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    device = resolve_device(args.device)
    use_kernel = args.kernel if args.kernel is not None else device.type == "cuda"
    cfg = RenderConfig(
        width=args.size, height=args.size, spp=args.spp, seed=5,
        use_kernel=use_kernel and args.soft == 0.0, soft_edges=args.soft,
    )
    spec = get_scene("cornell")
    scene_true, cam = spec.to_scene(device), spec.to_camera(device)

    print("rendering target...")
    with torch.no_grad():
        target = render_differentiable(scene_true, cam, cfg, device=device)

    # Perturb: move the ceiling light, tint the left wall (the JAX example's
    # start).
    center = scene_true.center.clone()
    center[8] += torch.tensor([8.0, -5.0, 0.0], device=device)
    color = scene_true.color.clone()
    color[0] = torch.tensor([0.3, 0.6, 0.3], device=device)
    scene0 = dataclasses.replace(scene_true, center=center, color=color)
    with torch.no_grad():
        loss0 = float(l2_image_loss(scene0, cam, target, cfg, device=device))
    print(f"initial loss {loss0:.6e}")

    t0 = time.time()
    st = run_inverse_rendering(
        scene0, cam, target, cfg, steps=args.steps, learning_rate=args.lr,
        param_filter=lambda n: n in ("center", "color"),
        log_every=max(1, args.steps // 10), device=device,
    )
    print(f"optimized {args.steps} steps in {time.time() - t0:.1f}s")

    err_center = float((st.scene.center.detach()[8] - scene_true.center[8]).abs().max())
    err_color = float((st.scene.color.detach()[0] - scene_true.color[0]).abs().max())
    print(f"final loss {float(st.loss):.6e}")
    print(f"light center error: {err_center:.3f} (was 8.0)")
    print(f"left-wall albedo error: {err_color:.3f} (was 0.45)")

    for tag, sc in [("target", scene_true), ("init", scene0), ("final", st.scene)]:
        with torch.no_grad():
            img = render_differentiable(sc, cam, cfg, device=device)
        write_png(to_srgb_bytes(img).cpu().numpy(), os.path.join(args.outdir, f"inverse_{tag}.png"))
    print(f"wrote inverse_{{target,init,final}}.png to {args.outdir}")
    return {"loss0": loss0, "loss": float(st.loss), "err_center": err_center,
            "err_color": err_color}


if __name__ == "__main__":
    main()
