"""End-to-end render times of two copies of the PyTorch/CUDA port, in turns,
on one GPU.

    python3 tools/render_ab_torch.py --old DIR [--new DIR] [--out FILE]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="directory holding the other copy of the package")
    ap.add_argument("--new", default=ROOT, help="directory of this copy (default: the checkout)")
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; render_ab_torch.py runs on a GPU", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker)))
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
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
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
