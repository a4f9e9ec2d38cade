"""How far rounding alone moves the end of an inverse-rendering run: the
spread of ``tools/grad_bench.py`` (the JAX package) and of
``tools/grad_bench_torch.py`` (the port) over starts a few float32 ulps
apart.

Each run is one of the two tools, unchanged, with Cornell's light centre x
moved by ``k`` float32 ulps (``--nudges``) in the scene the tool loads, so
the target and the start move together and nothing else changes. Adam
normalises each step, so a rounding-level change in a small gradient
component moves a parameter by about the learning rate, and the runs part.
Per side and mode (hard, soft) the script prints the light centre's error at
the best iterate and at the end over the nudges, and whether the JAX runs'
errors fall inside the port's range.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/grad_recovery_spread.py \\
        --sides jax torch --size 64 --steps 30 --nudges 0 1 -1 2 -2 3 -3 \\
        --out spread.json
    python tools/grad_recovery_spread.py --sides torch --device cuda --size 512 \\
        --steps 220 --nudges 0 1 -1 2 -2 --out chiprun_out/spread.json

The JAX side runs ``--no-pallas`` (its jnp path both ways), on the CPU;
each run is a child process, ``CPU_WORKERS`` at a time on the CPU, one at a
time on the card. Any other flag is
passed to both tools (``--spp``, ``--soft``, ``--sched-alpha``,
``--geom-mult-soft``; the JAX tool has no ``--seed`` and uses seed 5, the
port tool's default).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("hard", "soft")
CPU_WORKERS = 4


def _nudge(x: float, k: int) -> float:
    import numpy as np

    v = np.float32(x)
    for _ in range(abs(k)):
        v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf), dtype=np.float32)
    return float(v)


def _child(side: str, k: int, tool_args) -> int:
    """Run one tool in this process with Cornell's light centre x moved by
    ``k`` ulps in every scene its registry hands out."""
    pkg = "se195_raytracer_tpu" if side == "jax" else "se195_raytracer_tpu_torch"
    registry = __import__(f"{pkg}.scenes.registry", fromlist=["get_scene"])
    real = registry.get_scene

    class Nudged:
        def __init__(self, spec):
            self._spec = spec

        def __getattr__(self, name):
            return getattr(self._spec, name)

        def to_scene(self, *a, **kw):
            scene = self._spec.to_scene(*a, **kw)
            li = int(scene.light_indices[0])
            x = _nudge(float(scene.center[li, 0]), k)
            if side == "jax":
                return scene.replace(center=scene.center.at[li, 0].set(x))
            center = scene.center.clone()
            center[li, 0] = x
            return dataclasses.replace(scene, center=center)

    registry.get_scene = lambda name, *a, **kw: (Nudged(real(name, *a, **kw))
                                                  if name == "cornell" else real(name, *a, **kw))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    if side == "jax":
        import grad_bench

        sys.argv = ["grad_bench.py", "--no-pallas", *tool_args]
        grad_bench.main()
        return 0
    import grad_bench_torch

    return grad_bench_torch.main(tool_args)


def _run(side, k, tool_args, out_dir):
    out = os.path.join(out_dir, f"{side}_{k}.json")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if side == "jax":
        env["JAX_PLATFORMS"] = "cpu"
    if side == "jax" or tool_args[tool_args.index("--device") + 1] == "cpu":
        env["OMP_NUM_THREADS"] = "2"  # a few runs share the host's cores
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", side, str(k),
                           "--", *tool_args, "--out", out], env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{side} nudge {k} failed:\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    with open(out) as f:
        res = json.load(f)
    row = {"side": side, "nudge_ulps": k}
    for mode in MODES:
        m = res[mode]
        row[mode] = {"best_light_err": m["recovered_at_best"]["light_center_max_err"],
                     "final_light_err": m["recovered_at_final"]["light_center_max_err"],
                     "best_loss": m["best_loss"], "final_loss": m["final_loss"],
                     "best_step": m["best_step"]}
    print(f"{side} nudge {k:+d}: " + "; ".join(
        f"{mode} light err best {row[mode]['best_light_err']} final "
        f"{row[mode]['final_light_err']}" for mode in MODES), flush=True)
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return _child(argv[1], int(argv[2]), argv[4:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sides", nargs="+", choices=("jax", "torch"), default=["jax", "torch"])
    ap.add_argument("--nudges", nargs="+", type=int, default=[0, 1, -1, 2, -2])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cpu", help="the port's torch device")
    ap.add_argument("--out", default="grad_recovery_spread.json")
    args, rest = ap.parse_known_args(argv)
    common = ["--size", str(args.size), "--steps", str(args.steps), *rest]
    jobs = [(side, k, common + (["--device", args.device] if side == "torch" else []))
            for side in args.sides for k in args.nudges]
    workers = 1 if args.device.startswith("cuda") else CPU_WORKERS
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(workers) as pool:
        rows = list(pool.map(lambda j: _run(*j, tmp), jobs))
    summary = {}
    for side in args.sides:
        for mode in MODES:
            for key in ("best_light_err", "final_light_err"):
                vals = [r[mode][key] for r in rows if r["side"] == side]
                summary[f"{side} {mode} {key}"] = [min(vals), max(vals)]
    if set(args.sides) == {"jax", "torch"}:
        for mode in MODES:
            for key in ("best_light_err", "final_light_err"):
                lo, hi = summary[f"torch {mode} {key}"]
                jax_vals = [r[mode][key] for r in rows if r["side"] == "jax"]
                summary[f"jax {mode} {key} inside the port's range"] = [
                    lo <= v <= hi for v in jax_vals]
    for k, v in summary.items():
        print(f"{k}: {v}")
    out = {"config": {"size": args.size, "steps": args.steps, "nudges": args.nudges,
                      "device": args.device, "tool_args": rest}, "runs": rows,
           "summary": summary}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
