"""Split K1b's time into its parts (needs a GPU and nvcc).

    python3 tools/k1b_split.py [--tree DIR ...] [--spps 1 2 4 8] [--out FILE]

Each ``--tree`` names a directory that holds a ``se195_raytracer_tpu_torch``
package: this checkout by default, or another commit's tree unpacked with
``git archive <commit> se195_raytracer_tpu_torch | tar -x -C DIR`` into a
git-ignored directory (``_archive/``). For each tree and each variant
(``VARIANTS``) the package is copied into a temporary directory (no tree is
ever edited), the copy's ``csrc/pt_backward_kernel.cu`` (or its
``_build.py``) gets the variant's edits (each tree's kernels are built
first, into its own ``_build/``), the copies' K1b are built together
(one ``nvcc`` each, their ptxas lines printed), and one child process per
copy times K1b alone (CUDA events, median of ``REPS`` after a warm-up; and
one call's device time under torch.profiler, K1b's two kernels apart from
the seeding and the wrapper's small ops) on
the gradient step's cotangent: Cornell 512x512, PT, mwc, seed 0, the L2
loss's cotangent 2 (img - target) / numel with the target rendered from
``grad_check.grad_bench_start``'s scene. The variants:

- ``full``: the kernel as it stands;
- ``replay only``: the reverse sweep not run; every word of every record
  folded into a value that a never-true test consumes, so the compiler keeps
  the replay and its records;
- ``no table adds``: the reverse sweep runs, but each add of a gradient into
  the warp's table (and, in the lane-columns design, into a lane's column)
  is a never-true test of the value (a register sink);
- ``FMA allowed``: the replay's products and sums free to contract into
  FMAs (its result is timed, not checked);
- the atomics design only, ``reconverged each pass``: a ``__syncwarp()``
  after each pass's reverse sweep (every lane of Cornell 512x512 is live),
  so that no lane starts its next replay while another is still sweeping;
- the lockstep designs only, ``5 blocks an SM`` and ``6 blocks an SM``: the
  launch bounds' minimum raised from 4, so ptxas caps the registers at 102
  and 85.

Three K1b designs are known (``EDITS``): the per-lane adjoint with
shared-memory atomics into per-warp tables (``atomics``), the lockstep
sweep with a warp reduction round per sphere id for every row
(``lockstep``), and the lockstep sweep whose hit-sphere rows go into
per-lane columns in shared memory, folded once a block (``lane columns``);
a tree's source is matched to the one whose search strings each occur
exactly once. Each child also reads the card's SM clock during a
sustained run of the full kernel at each spp (``nvidia-smi`` from a thread
while the launches run). Prints one JSON line per tree and variant and a
table; ``--out`` writes the JSON too.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "se195_raytracer_tpu_torch"
CU = os.path.join(PKG, "kernels", "csrc", "pt_backward_kernel.cu")
BUILD = os.path.join(PKG, "kernels", "_build.py")
SIZE = 512
REPS = 7
SUSTAIN_S = 1.0

# A value no gradient or record word takes in these runs: a test against it
# keeps the value alive and never takes its branch.
_NEVER = "0x7F7FFFFDu"
_CONSUME = ("{ uint32_t x = 0u; for (int i = 0; i < nrec; ++i) { const uint32_t* w = "
            "reinterpret_cast<const uint32_t*>(&recs[i]); for (int k = 0; k < (int)(sizeof(Rec) "
            f"/ 4); ++k) x ^= w[k]; }} if (x == {_NEVER}) gb[0] += 1.0f; }}")
# design -> variant -> [(file, search string, replacement)]; "" as the
# search string prepends the replacement to the file.
EDITS = {
    "atomics": {
        "replay only": [(CU, "reverse<DIRECT_ONLY, RNG>(S, gt, cs, recs, nrec, kcx, kcy, "
                             "go * weights[pass], gb);", _CONSUME)],
        "no table adds": [
            (CU, "#include <cstdint>\n", "#include <cstdint>\n#define K1B_SINK(p, v) do { if "
                                         f"(__float_as_uint(v) == {_NEVER}) atomicAdd((p), (v)); }} "
                                         "while (0)\n"),
            (CU, "atomicAdd(&g[3 * j], v.x);", "K1B_SINK(&g[3 * j], v.x);"),
            (CU, "atomicAdd(&g[3 * j + 1], v.y);\n    atomicAdd(&g[3 * j + 2], v.z);\n  }\n  "
                 "__device__ __forceinline__ void radius(int j, float v) const { "
                 "atomicAdd(&g[3 * n + j], v); }",
             "K1B_SINK(&g[3 * j + 1], v.y);\n    K1B_SINK(&g[3 * j + 2], v.z);\n  }\n  "
             "__device__ __forceinline__ void radius(int j, float v) const { "
             "K1B_SINK(&g[3 * n + j], v); }"),
            (CU, "atomicAdd(&g[4 * n + 3 * j], v.x);\n    atomicAdd(&g[4 * n + 3 * j + 1], v.y);\n"
                 "    atomicAdd(&g[4 * n + 3 * j + 2], v.z);",
             "K1B_SINK(&g[4 * n + 3 * j], v.x);\n    K1B_SINK(&g[4 * n + 3 * j + 1], v.y);\n"
             "    K1B_SINK(&g[4 * n + 3 * j + 2], v.z);"),
            (CU, "atomicAdd(&g[7 * n + 3 * j], v.x);\n    atomicAdd(&g[7 * n + 3 * j + 1], v.y);\n"
                 "    atomicAdd(&g[7 * n + 3 * j + 2], v.z);",
             "K1B_SINK(&g[7 * n + 3 * j], v.x);\n    K1B_SINK(&g[7 * n + 3 * j + 1], v.y);\n"
             "    K1B_SINK(&g[7 * n + 3 * j + 2], v.z);"),
        ],
        "FMA allowed": [(BUILD, '    "pt_backward_kernel": ("-fmad=false",),\n', "")],
        "reconverged each pass": [(CU, "reverse<DIRECT_ONLY, RNG>(S, gt, cs, recs, nrec, kcx, "
                                       "kcy, go * weights[pass], gb);",
                                   "reverse<DIRECT_ONLY, RNG>(S, gt, cs, recs, nrec, kcx, kcy, "
                                   "go * weights[pass], gb);\n      __syncwarp();")],
    },
}
# The lockstep sweep's warp rounds with every add sunk.
_SINK_ROUNDS = (CU, "  unsigned todo = __ballot_sync(kFull, key >= 0);\n",
                "  bool never = false;\n  for (int c = 0; c < 8; ++c) never |= "
                f"__float_as_uint(v[c]) == {_NEVER};\n"
                "  if (never) put_slot(tab, n, key, at, 0, v[0]);\n"
                "  unsigned todo = 0u;\n")
EDITS["lockstep"] = {
    "replay only": [(CU, "reverse<DIRECT_ONLY, RNG>(S, wtab, cs, recs, nrec, kcx, kcy, "
                         "go * weights[pass], gb);", _CONSUME)],
    "no table adds": [_SINK_ROUNDS],
    "FMA allowed": [
        (CU, "return __fmul_rn(a, b); }", "return a * b; }"),
        (CU, "return __fadd_rn(a, b); }", "return a + b; }"),
        (CU, "return __fsub_rn(a, b); }", "return a - b; }"),
    ],
    "5 blocks an SM": [(CU, "constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 5;")],
    "6 blocks an SM": [(CU, "constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 6;")],
}
EDITS["lane columns"] = {
    **EDITS["lockstep"],
    "replay only": [(CU, "reverse<DIRECT_ONLY, RNG, COLS>(S, wtab, col, cs, recs, nrec, kcx, kcy, "
                         "go * weights[pass],\n                                    gb);", _CONSUME)],
    "no table adds": [
        (CU, "  for (int c = 0; c < 7; ++c) col[(c * n + j) * kThreads] += v[c];\n",
         f"  for (int c = 0; c < 7; ++c)\n    if (__float_as_uint(v[c]) == {_NEVER}) "
         "col[(c * n + j) * kThreads] += v[c];\n"),
        _SINK_ROUNDS,
    ],
}
VARIANTS = ("full", "replay only", "no table adds", "FMA allowed", "reconverged each pass",
            "5 blocks an SM", "6 blocks an SM")


def design_of(tree: str) -> str:
    """The K1b design whose search strings each occur once in ``tree``."""
    texts = {}
    for design, variants in EDITS.items():
        ok = True
        for edits in variants.values():
            for path, old, _ in edits:
                if path not in texts:
                    with open(os.path.join(tree, path)) as f:
                        texts[path] = f.read()
                ok &= old == "" or texts[path].count(old) == 1
        if ok:
            return design
    raise RuntimeError(f"{tree}: the K1b source matches no known design's search strings")


def _copy(src_tree: str, dst: str, edits) -> None:
    """The tree's package with its built kernels, but for K1b (each copy
    builds its own, and prints its ptxas lines)."""
    shutil.copytree(os.path.join(src_tree, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__", "pt_backward_kernel-*"))
    for path, old, new in edits:
        full = os.path.join(dst, path)
        with open(full) as f:
            text = f.read()
        if old and text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {path} exactly once")
        with open(full, "w") as f:
            f.write(text.replace(old, new) if old else new + text)


def _clock_during(fn, seconds: float) -> dict:
    """Run ``fn`` back to back for about ``seconds`` while a thread reads
    the SM clock and power once, halfway through."""
    import time

    import torch

    seen = {}

    def read():
        time.sleep(seconds / 2)
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True)
        seen["clocks_sm,power_draw"] = out.stdout.strip()

    fn()
    torch.cuda.synchronize()
    t = threading.Thread(target=read)
    start = time.perf_counter()
    t.start()
    n = 0
    while time.perf_counter() - start < seconds:
        fn()
        n += 1
        if n % 8 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    t.join()
    seen["calls"] = n
    return seen


def _device_ms(fn) -> dict:
    """The device time of one call by kernel name (torch.profiler, CUDA
    activity only), summed for K1b's two kernels and for the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"k1b_kernels": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is None or e.device_type.name == "CPU":
            continue
        ms = getattr(e, "self_device_time_total", 0) / 1e3
        mine = "pt_backward_kernel" in e.key or "reduce_partials" in e.key
        out["k1b_kernels" if mine else "other"] += ms
    return out


def _child(spps, sustain: bool) -> int:
    """In a copy of the port: K1b alone at each spp, one JSON line."""
    import statistics

    import torch

    import se195_raytracer_tpu_torch as pkg
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.core.types import CameraBasis, update_camera
    from se195_raytracer_tpu_torch.driver import grad_check as G
    from se195_raytracer_tpu_torch.driver.optimize import render_differentiable
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as K
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    assert os.path.abspath(pkg.__file__).startswith(os.getcwd()), pkg.__file__
    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    start = G.grad_bench_start(scene)
    out = {}
    for spp in spps:
        cfg = RenderConfig(width=SIZE, height=SIZE, spp=spp, seed=0)
        b = update_camera(cam, SIZE, SIZE)
        basis = CameraBasis(*(getattr(b, k).detach() for k in K.BASIS_FIELDS))
        with torch.no_grad():
            target = render_differentiable(start, cam, cfg)
            img = render_differentiable(scene, cam, cfg)
        cot = 2.0 * (img - target) / img.numel()

        def run():
            return K.pt_backward_cuda(scene, basis, cfg, cot)

        flat = run()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        row = {"ms": statistics.median(times), "reps_ms": times,
               "device_ms": _device_ms(run),
               "finite": bool(torch.isfinite(flat).all()), "abs_sum": float(flat.abs().sum())}
        if sustain:
            row["sustained"] = _clock_during(run, SUSTAIN_S)
        out[f"spp{spp}"] = row
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return _child([int(s) for s in argv[1].split(",")], argv[2] == "1")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="a directory holding the package "
                    "(repeatable; default: this checkout)")
    ap.add_argument("--spps", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; k1b_split.py runs on a GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    results = []
    # Each tree's kernels first, then copied with each variant: a copy then
    # builds only its edited K1b.
    build = ("import json; from se195_raytracer_tpu_torch.kernels._build import build_all, "
             "sources; print(json.dumps(build_all({})))")
    procs = [subprocess.Popen([sys.executable, "-c", build.format("sources()")], cwd=t,
                              stdout=subprocess.PIPE, text=True, env=dict(env, PYTHONPATH=t))
             for t in trees]
    for t, p in zip(trees, procs):
        p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{t}: the kernels did not build")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for ti, tree in enumerate(trees):
            design = design_of(tree)
            for vi, variant in enumerate(VARIANTS):
                if variant != "full" and variant not in EDITS[design]:
                    continue
                d = os.path.join(tmp, f"{ti}-{vi}")
                _copy(tree, d, [] if variant == "full" else EDITS[design][variant])
                jobs.append((tree, design, variant, d))
        procs = [subprocess.Popen([sys.executable, "-c", build.format("['pt_backward_kernel']")],
                                  cwd=d, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=dict(env, PYTHONPATH=d))
                 for *_, d in jobs]
        logs = []
        for (tree, design, variant, _), p in zip(jobs, procs):
            so, se = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{tree} {variant}: K1b did not build\n{so[-3000:]}\n"
                                   f"{se[-3000:]}")
            logs.append(json.loads(so.strip().splitlines()[-1])["pt_backward_kernel"])
        for (tree, design, variant, d), log in zip(jobs, logs):
            ptxas = [line.strip() for line in log.splitlines()
                     if "registers" in line or "stack frame" in line]
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 ",".join(map(str, args.spps)), "1" if variant == "full" else "0"],
                cwd=d, env=dict(env, PYTHONPATH=d), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{tree} {variant}: {proc.stdout[-2000:]}\n"
                                   f"{proc.stderr[-4000:]}")
            row = {"tree": os.path.relpath(tree, ROOT), "design": design, "variant": variant,
                   "ptxas": ptxas, **json.loads(proc.stdout.strip().splitlines()[-1])}
            results.append(row)
            print(json.dumps(row), flush=True)
    print(f"K1b alone, ms (median of {REPS}, CUDA events), Cornell {SIZE}x{SIZE} PT/mwc seed 0, "
          f"{card}:")
    print("  tree | design | variant | " + " | ".join(f"spp {s}" for s in args.spps)
          + f" | spp {args.spps[-1]} / spp {args.spps[min(1, len(args.spps) - 1)]}")
    for r in results:
        ms = [r[f"spp{s}"]["ms"] for s in args.spps]
        dev = [r[f"spp{s}"]["device_ms"]["k1b_kernels"] for s in args.spps]
        print(f"  {r['tree']} | {r['design']} | {r['variant']} | "
              + " | ".join(f"{m:.4f} ({d:.4f})" for m, d in zip(ms, dev))
              + f" | {ms[-1] / ms[min(1, len(ms) - 1)]:.3f}")
    print("  (in brackets: the device time of K1b's two kernels in one call, torch.profiler)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "size": SIZE, "reps": REPS, "rows": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
