"""Split the time of K3's debug taps into its parts (needs a GPU and nvcc).

    python3 tools/taps_split_torch.py [--tree DIR ...] [--out FILE]

Each ``--tree`` names a directory that holds a ``se195_raytracer_tpu_torch``
package: this checkout by default, or another commit's tree unpacked with
``git archive <commit> se195_raytracer_tpu_torch | tar -x -C DIR`` into a
git-ignored directory (``_archive/``). For each tree and each variant
(``VARIANTS``) the package is copied into a temporary directory (no tree is
ever edited), the copy's ``csrc/whitted_kernel.cu`` gets the variant's
edits to the tap kernel (K3's own entries are left as they are), the copies
are built together (one ``nvcc`` each; the tap kernels' ptxas lines are
printed), and one child process per copy times the taps on the Whitted
room's camera rays at 800x600, 3x3 (4.32 M rays, hit_bias 0): the wrapper
by CUDA events (median of ``REPS`` after a warm-up) and the tap kernel's
device time in one call (torch.profiler). The variants:

- ``full``: the kernel as it stands, each of ``tres``, ``attr`` and
  ``shade`` (and, for this one, each tap bitwise the plain ``whitted_taps``);
- ``prologue only``: the scene load, then each ray's triple written from
  the scene, without reading the rays or folding over the primitives;
- ``rays only``: no scene load and no fold: each ray read and a triple of
  it written, the bytes that bound ``tres`` and ``attr``;
- the persistent grid only, each tap: ``static stride`` (each block takes
  every grid-th chunk of rays, in place of the next chunk from the
  counter) and ``one ray a thread`` (the grid sized to the rays, not to
  the blocks the card holds).

Two tap designs are known (``EDITS``): one ray a thread with the scene
loaded by every block (its light and occluder lists built by one thread),
and the persistent grid (a block per resident slot, the scene loaded once,
the lists from the wrapper, the rays taken from a counter); a tree's
source is matched to the one whose search strings each occur exactly
once. Prints one JSON line per tree and variant and a table; ``--out``
writes the JSON too. With two trees the ``full`` rows run in turns
(first, second, second, first), and the table gives each tree's median of
its two runs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "se195_raytracer_tpu_torch"
CU = os.path.join(PKG, "kernels", "csrc", "whitted_kernel.cu")
WIDTH, HEIGHT, SS = 800, 600, 3
REPS = 15
TAPS = ("tres", "attr", "shade")

# Each ray's triple from the scene alone (i: the ray, s: the loaded scene).
_FROM_SCENE = ("out[i] = s.geom[i % s.n].x; out[rp + i] = __int_as_float(s.kind[i % s.n]); "
               "out[2 * rp + i] = __int_as_float(s.occ[i % s.n] + s.nl + s.no);")
# Each ray's triple from the ray alone.
_FROM_RAY = ("out[i] = rays[i] + rays[3 * rp + i]; out[rp + i] = rays[rp + i] + rays[4 * rp + i]; "
             "out[2 * rp + i] = rays[2 * rp + i] + rays[5 * rp + i];")
_PER_THREAD_LOAD = ("  const Scene s = load_scene(table, light, n, bias, smem, L);\n"
                    "  const int i = blockIdx.x * kThreads + threadIdx.x;\n"
                    "  if (i >= rp) return;\n"
                    "  const float ox = rays[i], oy = rays[rp + i], oz = rays[2 * rp + i];")
_PERSISTENT_LOAD = ("  const Scene s = load_tap_scene(table, light, lists, n, nl, no, bias, "
                    "smem, L);\n")
_PERSISTENT_LOOP = ("  for (int i = blockIdx.x * kThreads + threadIdx.x; i < rp; "
                    "i += gridDim.x * kThreads) {\n")
_TICKETS = ("  int* chunk = reinterpret_cast<int*>(smem + L.counts);\n"
            "  for (int k = 0;; ++k) {\n"
            "    if (threadIdx.x == 0) chunk[k & 1] = int(atomicAdd(work, 1u));\n"
            "    __syncthreads();\n"
            "    const int first = chunk[k & 1] * kThreads;\n"
            "    if (first >= rp) break;\n"
            "    const int i = first + threadIdx.x;\n"
            "    if (i >= rp) continue;\n")
_GRID = "  const int blocks = needed < resident ? needed : resident;\n"
# design -> variant -> [(search string, replacement)] in CU.
EDITS = {
    "one ray a thread": {
        "prologue only": [(_PER_THREAD_LOAD, _PER_THREAD_LOAD.replace(
            "  if (i >= rp) return;\n", "  if (i >= rp) return;\n  { " + _FROM_SCENE
            + " return; }\n"))],
        "rays only": [(_PER_THREAD_LOAD, "  { const int i = blockIdx.x * kThreads + threadIdx.x; "
                       "if (i < rp) { " + _FROM_RAY + " } return; }\n" + _PER_THREAD_LOAD)],
    },
    "persistent grid": {
        "prologue only": [(_PERSISTENT_LOAD, _PERSISTENT_LOAD + "  { " + _PERSISTENT_LOOP + "    "
                           + _FROM_SCENE + "\n  }\n  return; }\n")],
        "rays only": [(_PERSISTENT_LOAD, "  { " + _PERSISTENT_LOOP + "    " + _FROM_RAY
                       + "\n  }\n  return; }\n" + _PERSISTENT_LOAD)],
        "one ray a thread": [(_GRID, "  const int blocks = needed;\n")],
        "static stride": [(_TICKETS, _PERSISTENT_LOOP)],
    },
}
VARIANTS = ("full", "prologue only", "rays only", "one ray a thread", "static stride")
# Variants timed for every tap; the others for tres alone.
EVERY_TAP = ("full", "one ray a thread", "static stride")


def design_of(tree: str) -> str:
    """The tap design whose search strings each occur once in ``tree``."""
    with open(os.path.join(tree, CU)) as f:
        text = f.read()
    for design, variants in EDITS.items():
        if all(text.count(old) == 1 for edits in variants.values() for old, _ in edits):
            return design
    raise RuntimeError(f"{tree}: the tap kernel matches no known design's search strings")


def _copy(src_tree: str, dst: str, edits) -> None:
    """The tree's package with its built kernels, but for K3's library
    (each copy builds its own, and prints its ptxas lines)."""
    shutil.copytree(os.path.join(src_tree, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__", "whitted_kernel-*"))
    full = os.path.join(dst, CU)
    with open(full) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {CU} exactly once")
        text = text.replace(old, new)
    with open(full, "w") as f:
        f.write(text)


def _device_ms(fn) -> float:
    """The tap kernel's device time in one call (torch.profiler, CUDA
    activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session that caught no tap kernel is made again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if "whitted_taps_kernel" in e.key) / 1e3
        if ms > 0:
            return ms
    return float("nan")


def _child(variant: str) -> int:
    """In a copy of the port: each tap on room's camera rays, one JSON line."""
    import torch

    import se195_raytracer_tpu_torch as pkg
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.models import whitted as W
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    assert os.path.abspath(pkg.__file__).startswith(os.getcwd()), pkg.__file__
    scene = WHITTED_SCENES["room"]("cuda")
    o, d = W.whitted_camera_rays_device(WIDTH, HEIGHT, SS, device="cuda")
    tiles = wk.rays_to_tiles(o, d)
    flat = tiles.reshape(6, -1)
    out = {}
    for tap in TAPS if variant in EVERY_TAP else TAPS[:1]:
        def run(tap=tap):
            return wk.whitted_taps_cuda(scene, tiles, tap=tap)

        got = run()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        row = {"ms": statistics.median(times), "reps_ms": times, "device_ms": _device_ms(run)}
        if variant == "full":
            plain = W.whitted_taps(scene, flat[0:3].T, flat[3:6].T, tap, 0.0)
            row["bitwise_plain"] = bool(torch.equal(got.reshape(3, -1).T, plain))
        out[tap] = row
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return _child(argv[1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="a directory holding the package "
                    "(repeatable; default: this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_summary

    if not torch.cuda.is_available():
        print("error: no CUDA device; taps_split_torch.py runs on a GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    results = []
    build = ("import json; from se195_raytracer_tpu_torch.kernels._build import build_all, "
             "sources; print(json.dumps(build_all({})))")
    # Each tree's kernels first, then copied with each variant: a copy then
    # builds only its edited K3 library.
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
        runs = [job for job in jobs if job[2] == "full"]
        runs = (runs + runs[::-1] if len(runs) == 2 else runs) + [
            job for job in jobs if job[2] != "full"]
        procs = [subprocess.Popen([sys.executable, "-c", build.format("['whitted_kernel']")],
                                  cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True, env=dict(env, PYTHONPATH=d))
                 for *_, d in jobs]
        logs = []
        for (tree, _, variant, _), p in zip(jobs, procs):
            so, se = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{tree} {variant}: K3 did not build\n{so[-3000:]}\n"
                                   f"{se[-3000:]}")
            logs.append(json.loads(so.strip().splitlines()[-1])["whitted_kernel"])
        logs = {job[3]: log for job, log in zip(jobs, logs)}
        for tree, design, variant, d in runs:
            log = logs[d]
            ptxas = [f"{name}: {regs} registers, {frame} B stack frame, {st} B spill stores, "
                     f"{ld} B spill loads" for name, regs, frame, st, ld in ptxas_summary(log)
                     if "taps" in name]
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", variant],
                                  cwd=d, env=dict(env, PYTHONPATH=d), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{tree} {variant}: {proc.stdout[-2000:]}\n"
                                   f"{proc.stderr[-4000:]}")
            row = {"tree": os.path.relpath(tree, ROOT), "design": design, "variant": variant,
                   "ptxas": ptxas, **json.loads(proc.stdout.strip().splitlines()[-1])}
            results.append(row)
            print(json.dumps(row), flush=True)
    print(f"K3's taps, ms (median of {REPS}, CUDA events; in brackets the tap kernel's device "
          f"time, torch.profiler), room {WIDTH}x{HEIGHT} {SS}x{SS}, {card}:")
    rows = {}
    for r in results:
        rows.setdefault((r["tree"], r["design"], r["variant"]), []).append(r)
    for (tree, design, variant), rs in rows.items():
        cells = " | ".join(
            f"{tap} {statistics.median(r[tap]['ms'] for r in rs):.4f} "
            f"({statistics.median(r[tap]['device_ms'] for r in rs):.4f})"
            for tap in TAPS if tap in rs[0])
        print(f"  {tree} | {design} | {variant} | {cells}"
              + (f" (median of {len(rs)} runs in turns)" if len(rs) > 1 else ""))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "reps": REPS, "rows": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
