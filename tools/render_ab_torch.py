"""End-to-end render times, or gradient-step times, of two copies of the
PyTorch/CUDA port, in turns, on one GPU.

    python3 tools/render_ab_torch.py --old DIR [--new DIR] [--grad] [--out FILE]

DIR holds a ``se195_raytracer_tpu_torch`` package: another commit's tree,
unpacked with ``git archive <commit> se195_raytracer_tpu_torch | tar -x -C
DIR`` into a git-ignored directory (``_archive/``). ``--new`` defaults to
this checkout. The copies run in turns, old, new, new, old, each in a
process of its own that imports the package from its directory and builds
its kernels into that copy's ``_build/``. Each run times, median of REPS
after a warm-up (host clock, synchronised, the image read back to the host):

- ``init_pt_state`` at Cornell 512x512 (K1's layout) and complex783's
  blocked layout;
- Cornell 512x512 x 8 spp through ``driver.render.render`` (K1);
- complex783 512x512 x 8 spp through ``render`` (K2);
- Cornell through ``render_cuda_sharded`` on 8 shards of cuda:0, and its
  ratio to the one-launch render.

With ``--grad`` each run times instead, at Cornell 512x512, PT, mwc, seed 0,
spp 2 and 8 (``GRAD_SPPS``): K1b alone (``pt_backward_cuda``, CUDA events)
on the hard step's cotangent, the L2 loss's 2 (img - target) / numel with
the target rendered from ``grad_check.grad_bench_start``'s scene; the hard
gradient step (``render_differentiable`` forward, the loss's backward to
every leaf; host clock, synchronised); and, at spp 2, the card's idle share
over the step (torch.profiler's device time against the step's time).

Prints one JSON line per run and, last, one summary line with each
metric's medians over the two runs of each copy and new / old; ``--out``
writes them to FILE too. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 15
GRAD_SPPS = (2, 8)
WIDTH = HEIGHT = 512
SPP = 8
SHARDS = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ms(fn, reps=REPS):
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def worker(root: str) -> dict:
    """One run: import the package from ``root`` and time the cells."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import se195_raytracer_tpu_torch as pkg
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver.render import render
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.parallel import render_sharded as rs
    from se195_raytracer_tpu_torch.parallel.mesh import make_mesh
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if not where.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported the package from {where}, not from {root}")
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, seed=0)
    out = {"root": root}
    mesh = make_mesh("cuda:0", n_devices=SHARDS)
    for name in ("cornell", "complex"):
        spec = get_scene(name)
        scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
        blocked = scene.num_spheres > ptk.UNROLL_MAX_SPHERES
        out[f"{name}_seed_ms"] = _ms(lambda: ptk.init_pt_state(cfg, "cuda", blocked))
        out[f"{name}_e2e_ms"] = _ms(lambda: render(scene, camera, cfg)[0].cpu())
        if name == "cornell":
            out["cornell_8shard_e2e_ms"] = _ms(
                lambda: rs.render_cuda_sharded(scene, camera, cfg, mesh)[0].cpu())
            out["cornell_8shard_ratio"] = out["cornell_8shard_e2e_ms"] / out["cornell_e2e_ms"]
    return out


def grad_worker(root: str) -> dict:
    """One ``--grad`` run: import the package from ``root`` and time K1b and
    the hard gradient step."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import se195_raytracer_tpu_torch as pkg
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.core.types import Camera, CameraBasis, Scene, update_camera
    from se195_raytracer_tpu_torch.driver import grad_check as G
    from se195_raytracer_tpu_torch.driver.optimize import render_differentiable
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as K
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if not where.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported the package from {where}, not from {root}")
    spec = get_scene("cornell")
    scene0, cam0 = spec.to_scene("cuda"), spec.to_camera("cuda")
    start = G.grad_bench_start(scene0)
    out = {"root": root}
    for spp in GRAD_SPPS:
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=spp, seed=0)
        with torch.no_grad():
            target = render_differentiable(start, cam0, cfg)
            img = render_differentiable(scene0, cam0, cfg)
        cot = 2.0 * (img - target) / img.numel()
        b = update_camera(cam0, WIDTH, HEIGHT)
        basis = CameraBasis(*(getattr(b, k).detach() for k in K.BASIS_FIELDS))

        def k1b():
            K.pt_backward_cuda(scene0, basis, cfg, cot)

        k1b()
        times = []
        for _ in range(REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            k1b()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        out[f"k1b_spp{spp}_ms"] = statistics.median(times)
        leaves = [t.detach().clone().requires_grad_(True) for t in
                  (scene0.center, scene0.radius, scene0.emission, scene0.color, cam0.orig,
                   cam0.target)]
        scene = Scene(*leaves[:4], scene0.refl, scene0.light_indices)
        camera = Camera(*leaves[4:])

        def step():
            for t in leaves:
                t.grad = None
            torch.mean((render_differentiable(scene, camera, cfg) - target) ** 2).backward()

        out[f"step_spp{spp}_ms"] = _ms(step)
        if spp == GRAD_SPPS[0]:
            step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                       if getattr(e, "device_type", None) is not None
                       and e.device_type.name != "CPU") / 1e3
            out[f"step_spp{spp}_busy_ms"] = busy
            out[f"step_spp{spp}_idle_ratio"] = max(0.0, 1.0 - busy / out[f"step_spp{spp}_ms"])
    out["k1b_spp8_over_spp2_ratio"] = out["k1b_spp8_ms"] / out["k1b_spp2_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="directory holding the other copy of the package")
    ap.add_argument("--new", default=ROOT, help="directory of this copy (default: the checkout)")
    ap.add_argument("--grad", action="store_true",
                    help="time K1b and the hard gradient step instead of the renders")
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; render_ab_torch.py runs on a GPU", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps((grad_worker if args.grad else worker)(args.worker)))
        return 0
    if not args.old:
        ap.error("--old is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = []
    for label in ("old", "new", "new", "old"):
        root = os.path.abspath(getattr(args, label))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root]
                              + (["--grad"] if args.grad else []),
                              capture_output=True, text=True, env=env, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["copy"] = label
        runs.append(line)
        print(json.dumps(line))
    keys = [k for k in runs[0] if k.endswith(("_ms", "_ratio"))]
    summary = {"card": card}
    for k in keys:
        old = statistics.median(r[k] for r in runs if r["copy"] == "old")
        new = statistics.median(r[k] for r in runs if r["copy"] == "new")
        summary[k] = {"old": old, "new": new, "new_over_old": new / old}
    print(json.dumps({"summary": summary}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for line in runs + [{"summary": summary}]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
