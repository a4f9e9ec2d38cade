"""A/B of the port's hand-written kernels against the sources of the parent
commit, on one GPU, in one process.

    mkdir -p _archive/parent
    for f in pt_kernel whitted_kernel whitted5_kernel; do
      git show 42f64b8:se195_raytracer_tpu_torch/kernels/csrc/$f.cu > _archive/parent/$f.cu
    done
    python3 kernel_ab.py [--old _archive/parent] [--splits K2 K3 K4]

Builds the current sources (``kernels/_build.py``) and the old ones (same
nvcc flags, into ``<old>/_build/``), prints each kernel's ptxas registers,
stack frame and spills, then times each kernel in turns (old, new, new,
old; CUDA events around back-to-back launches, median of 5 after a
warm-up) at the shapes of
chip_smoke.py's main paths: K3 on the Whitted room frame (800x600, 3x3,
depth 5), K2 on complex783 512x512 x 8 spp, K1 on Cornell 512x512 x 8 spp
(PT/mwc and DL/mwc timed; PT/counter compared too), K4 on room5 800x600
spp 8. Old and new outputs are compared bitwise (K2 also cull on against
cull off). The old sources run through the current wrappers, so they must
have the current C entry points, as the parent commit's do.

``--old`` defaults to ``_archive/parent`` (git-ignored), which the lines
above fill with the parent commit's sources; without it only the current
sources are built. Any other copy of the three sources is A/B'd the same
way: a variant of a kernel (another block size, say) is a copy with the
change made by hand, run with ``--old`` pointing at it. ``--splits``
prints chip_smoke.py's split lines of the named kernels, for both versions
when there is an old one. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

WHITTED = dict(width=800, height=600, supersample=3, trace_depth=5)
SOURCES = ("pt_kernel", "whitted_kernel", "whitted5_kernel")


def start_build(src_dir: Path):
    """Start one nvcc per src_dir/<name>.cu, with the flags _build.py gives
    the current source, into src_dir/_build/; returns {name: (process,
    library path)}."""
    from se195_raytracer_tpu_torch.kernels import _build

    out_dir = src_dir / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.flags(name), "-o", str(out), str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    return procs


def finish_build(procs):
    """Wait for ``start_build``'s compiles; returns ({name: CDLL}, {name:
    log}) with the current libraries' argument types set."""
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk

    current = {"pt_kernel": ptk._kernel_lib(), "whitted_kernel": wk._kernel_lib(),
               "whitted5_kernel": tk.kernel_lib()}
    libs, logs = {}, {}
    for name, (proc, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{logs[name]}")
        lib = libs[name] = ctypes.CDLL(str(out))
        for fn in ("pt_multi_pass_cuda", "pt_blocked_pass_cuda", "whitted_trace_cuda",
                   "whitted_frame_cuda", "whitted5_trace_cuda", "texel_fetch_cuda"):
            if hasattr(current[name], fn):
                getattr(lib, fn).argtypes = getattr(current[name], fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
    return libs, logs


@contextlib.contextmanager
def using(module, lib, attr="_kernel_lib"):
    """Run ``module``'s wrappers on ``lib`` (same C entry points)."""
    saved = getattr(module, attr)
    setattr(module, attr, lambda: lib)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def turns(label, old_fn, new_fn, reps=cs.REPS, timer=None):
    """old, new, new, old; prints each median and returns (old, new) means."""
    timer = timer or (lambda fn: cs.median_ms(fn, reps=reps))
    got = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        ms, _ = timer(old_fn if which == "old" else new_fn)
        got[which].append(ms)
    old, new = statistics.mean(got["old"]), statistics.mean(got["new"])
    print(f"  A/B {label}: old {got['old'][0]:.4f} / {got['old'][1]:.4f} ms, new "
          f"{got['new'][0]:.4f} / {got['new'][1]:.4f} ms; old / new {old / new:.3f}x")
    return old, new


def equal(a, b):
    import torch

    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def ab_k3(lib):
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    room = WHITTED_SCENES["room"]("cuda")
    frame = lambda: wk.whitted_frame_cuda(room, **WHITTED)  # noqa: E731

    def old_frame():
        with using(wk, lib):
            return frame()

    print(f"  K3 room frame: new bitwise equal to old: {equal([old_frame()], [frame()])}")
    turns("K3 room 800x600 3x3 depth 5", old_frame, frame, timer=lambda fn: cs.launch_ms(fn, n=10))


def ab_k2(lib):
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    scene_tab, cam_tab, (s0, s1, acc), pix, kw = cs.pass_inputs(
        cs.COMPLEX, cs.WIDTH, cs.HEIGHT, "pt", "mwc", "cuda")
    kw["num_samples"] = cs.SPP

    def k2(cull=True):
        return ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, cull=cull, **kw)

    def old_k2():
        with using(ptk, lib):
            return k2()

    new = k2()
    print(f"  K2 complex783 8 spp: new bitwise equal to old: {equal(old_k2(), new)}; new cull "
          f"on == new cull off: {equal(new, k2(cull=False))}")
    turns(f"K2 complex783 {cs.WIDTH}x{cs.HEIGHT} x {cs.SPP} spp", old_k2, k2,
          timer=lambda fn: cs.launch_ms(fn, n=5))


def k1_call(integrator, rng):
    """(fn, label): K1 at Cornell 512x512 x 8 spp through pt_multi_pass."""
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    scene_tab, cam_tab, (s0, s1, acc), _, kw = cs.pass_inputs(
        cs.SCENE, cs.WIDTH, cs.HEIGHT, integrator, rng, "cuda")
    fn = lambda: ptk.pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc,  # noqa: E731
                                   num_samples=cs.SPP, **kw)
    return fn, f"K1 Cornell {cs.WIDTH}x{cs.HEIGHT} x {cs.SPP} spp {integrator}/{rng}"


def ab_k1(lib, timed=(("pt", "mwc"), ("dl", "mwc"))):
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    for integrator, rng in (("pt", "mwc"), ("dl", "mwc"), ("pt", "counter")):
        new, label = k1_call(integrator, rng)

        def old(new=new):
            with using(ptk, lib):
                return new()

        print(f"  {label}: new bitwise equal to old (s0, s1, acc): {equal(old(), new())}")
        if (integrator, rng) in timed:
            turns(label, old, new, timer=lambda fn: cs.launch_ms(fn, n=20))


def ab_k4(lib):
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k

    spp8, four, label = k4_calls()

    def old(fn):
        with using(w5k, lib, "kernel_lib"):
            return fn()

    print(f"  {label}: new bitwise equal to old: colour and primary ids "
          f"{equal(spp8(), old(spp8))}; 4-ray colour {equal(four(), old(four))}")
    turns(label, lambda: old(spp8), spp8, timer=lambda fn: cs.launch_ms(fn, n=5))


def k4_calls():
    """(spp-8 call, 4-ray call, label): K4 at room5 800x600 through
    whitted5_trace_cuda, the spp-8 one with the primary ids."""
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P
    from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S

    w, h = cs.W5_SIZES[-1]
    scene = S.WHITTED5_SCENES["room5"]("cuda")
    o, d = P._cached_rays5(w, h, (0.5, 0.5), "cuda")
    o4, d4 = P._cached_rays5_4(w, h, "cuda")
    state = P._cached_state5(w * h, cs.W5_SEED, "cuda")

    def spp8():
        col, _, idx = w5k.whitted5_trace_cuda(scene, o, d, state, spp=cs.W5_SPP,
                                              return_primary_idx=True)
        return col, idx

    def four():
        return (w5k.whitted5_trace_cuda(scene, o4, d4, state, spp=4)[0],)

    return spp8, four, f"K4 room5 {w}x{h} spp {cs.W5_SPP}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=Path("_archive/parent"),
                    help="directory with the old .cu sources (default: %(default)s)")
    ap.add_argument("--splits", nargs="*", choices=("K2", "K3", "K4"), default=(),
                    help="print these kernels' split lines")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.kernels._build import build_all, sources
    from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    print(f"card: {cs.card_line()}")
    logs = build_all(sources())
    if not any(logs.values()):
        print("  (current sources built already: their ptxas lines are in that build's log)")
    cs.print_ptxas(logs, "new ")
    old = None
    if all((args.old / f"{name}.cu").exists() for name in SOURCES):
        old, logs = finish_build(start_build(args.old))
        cs.print_ptxas(logs, "old ")
    else:
        print(f"  no old sources in {args.old}: the current sources only")

    w, h = WHITTED["width"], WHITTED["height"]
    k2_works, k3_works, k4_works = {}, {}, {}
    for tag in ("new", "old") if old else ("new",):
        if not args.splits:
            break
        print(f"[split] {tag}")
        with contextlib.ExitStack() as stack:
            if tag == "old":
                stack.enter_context(using(wk, old["whitted_kernel"]))
                stack.enter_context(using(ptk, old["pt_kernel"]))
                stack.enter_context(using(w5k, old["whitted5_kernel"], "kernel_lib"))
            if "K3" in args.splits:
                cs.k3_split(WHITTED_SCENES["room"]("cuda"), w, h, k3_works)
            if "K2" in args.splits:
                cs.k2_split(cs.WIDTH, cs.HEIGHT, cs.SPP, k2_works)
            if "K4" in args.splits:
                w5, h5 = cs.W5_SIZES[-1]
                cs.k4_split(S.WHITTED5_SCENES["room5"]("cuda"), w5, h5, k4_works)
    if old:
        print("[A/B] old, new, new, old")
        for fn, source in ((ab_k4, "whitted5_kernel"), (ab_k1, "pt_kernel"),
                           (ab_k2, "pt_kernel"), (ab_k3, "whitted_kernel")):
            fn(old[source])
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
