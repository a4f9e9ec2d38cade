"""A/B of the port's K1, K2 and K3 kernels against the sources of the
parent commit, on one GPU, in one process.

    mkdir -p _archive/parent
    git show HEAD~1:se195_raytracer_tpu_torch/kernels/csrc/pt_kernel.cu > _archive/parent/pt_kernel.cu
    git show HEAD~1:se195_raytracer_tpu_torch/kernels/csrc/whitted_kernel.cu > _archive/parent/whitted_kernel.cu
    python3 kernel_ab.py --old _archive/parent [--splits]

Builds the current sources (``kernels/_build.py``) and the old ones (same
nvcc flags, into ``<old>/_build/``), prints each kernel's ptxas registers,
stack frame and spills, then times each kernel in turns (old, new, new, old;
CUDA events, median of 7 after a warm-up) at the shapes of chip_smoke.py's
main paths: K3 on the Whitted room frame (800x600, 3x3, depth 5), K2 on
complex783 512x512 x 8 spp, K1 on Cornell 512x512 x 8 spp. The old and new
outputs are compared (K3 and K1 bitwise; K2 by its largest difference).
``--splits`` also prints chip_smoke.py's K3 and K2 split lines for both
versions. Without ``--old`` only the current sources are built, and the
splits run on them. The old sources are those of commit c7bff9f: the same
C entry points of K1 and K3 as now, and K2's before its half-block, group
and remainder bounds. Needs a CUDA device; imports nothing of JAX.
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


def build_old(src_dir: Path):
    """Compile src_dir/{pt_kernel,whitted_kernel}.cu as _build.py compiles
    the current ones; returns ({name: CDLL}, {name: log})."""
    from se195_raytracer_tpu_torch.kernels import _build

    out_dir = src_dir / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("pt_kernel", "whitted_kernel"):
        out = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.flags(name), "-o", str(out), str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk

    libs, logs = {}, {}
    for name, (proc, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for old {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(out))
    # The current wrappers' argument lists; the old K2 entry lacks halves
    # (after n) and groups, ng, rest (after nb).
    new_w, new_k = wk._kernel_lib(), ptk._kernel_lib()
    w, k = libs["whitted_kernel"], libs["pt_kernel"]
    for fn in ("whitted_trace_cuda", "whitted_frame_cuda"):
        getattr(w, fn).argtypes = getattr(new_w, fn).argtypes
    k.pt_multi_pass_cuda.argtypes = new_k.pt_multi_pass_cuda.argtypes
    blocked = new_k.pt_blocked_pass_cuda.argtypes
    k.pt_blocked_pass_cuda.argtypes = blocked[0:2] + blocked[3:5] + blocked[8:]
    for fn in (w.whitted_trace_cuda, w.whitted_frame_cuda, k.pt_multi_pass_cuda,
               k.pt_blocked_pass_cuda):
        fn.restype = ctypes.c_int
    return libs, logs


@contextlib.contextmanager
def using(module, lib):
    """Run ``module``'s wrappers on ``lib`` (same C entry points)."""
    saved = module._kernel_lib
    module._kernel_lib = lambda: lib
    try:
        yield
    finally:
        module._kernel_lib = saved


def old_k2(lib):
    """K2 of the old library on the new wrapper's inputs."""
    import torch

    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    def run(scene_tab, cam_tab, s0, s1, acc, pix, cull, *, num_samples, width, height,
            max_depth, direct_only, light_indices, rng):
        _, bounds, _, _, lights = ptk._k2_tables(scene_tab, tuple(light_indices))
        outs = (torch.empty_like(s0), torch.empty_like(s1), torch.empty_like(acc))
        err = lib.pt_blocked_pass_cuda(
            scene_tab.data_ptr(), scene_tab.shape[1], bounds.data_ptr(), bounds.shape[1],
            int(cull), pix.data_ptr(), lights.data_ptr(), len(light_indices),
            cam_tab.data_ptr(), 0, int(num_samples), s0.data_ptr(), s1.data_ptr(),
            acc.data_ptr(), *(t.data_ptr() for t in outs),
            *ptk._frame_args(s0, width, height, max_depth, direct_only, rng))
        if err != 0:
            raise RuntimeError(f"old pt_blocked_pass_cuda failed: cudaError {err}")
        return outs

    return run


def new_k2(scene_tab, cam_tab, s0, s1, acc, pix, cull, **kw):
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    return ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, cull=cull, **kw)


def turns(label, old_fn, new_fn, reps=cs.REPS):
    """old, new, new, old; prints each median and returns (old, new) means."""
    got = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        ms, _ = cs.median_ms(old_fn if which == "old" else new_fn, reps=reps)
        got[which].append(ms)
    old, new = statistics.mean(got["old"]), statistics.mean(got["new"])
    print(f"  A/B {label}: old {got['old'][0]:.4f} / {got['old'][1]:.4f} ms, new "
          f"{got['new'][0]:.4f} / {got['new'][1]:.4f} ms; old / new {old / new:.3f}x")
    return old, new


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="directory with the old .cu sources")
    ap.add_argument("--splits", action="store_true", help="print the K3 and K2 splits")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.kernels._build import build_all, sources
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    print(f"card: {cs.card_line()}")
    logs = build_all(sources())
    if not any(logs.values()):
        print("  (current sources built already: their ptxas lines are in that build's log)")
    cs.print_ptxas(logs, "new ")
    old = None
    if args.old:
        old, logs = build_old(args.old)
        cs.print_ptxas(logs, "old ")

    w, h = WHITTED["width"], WHITTED["height"]
    room = WHITTED_SCENES["room"]("cuda")
    if args.splits:
        k3_works, k2_works = {}, {}
        print("[split] new")
        cs.k3_split(room, w, h, k3_works)
        cs.k2_split(cs.WIDTH, cs.HEIGHT, cs.SPP, k2_works)
        if old:
            print("[split] old")
            with using(wk, old["whitted_kernel"]):
                cs.k3_split(room, w, h, k3_works)
            cs.k2_split(cs.WIDTH, cs.HEIGHT, cs.SPP, k2_works, pass_fn=old_k2(old["pt_kernel"]))
    if not old:
        return 0

    print("[A/B] old, new, new, old")
    frame = lambda: wk.whitted_frame_cuda(room, **WHITTED)  # noqa: E731

    def old_frame():
        with using(wk, old["whitted_kernel"]):
            return frame()

    a, b = old_frame(), frame()
    print(f"  K3 room frame: new bitwise equal to old: {bool(torch.equal(a, b))}")
    turns("K3 room 800x600 3x3 depth 5", old_frame, frame)
    ab_k2(old["pt_kernel"])
    ab_k1(old["pt_kernel"])
    print(f"card: {cs.card_line()}")
    return 0


def ab_k2(lib):
    import torch

    scene_tab, cam_tab, (s0, s1, acc), pix, kw = cs.pass_inputs(
        cs.COMPLEX, cs.WIDTH, cs.HEIGHT, "pt", "mwc", "cuda")
    kw["num_samples"] = cs.SPP
    run_old = old_k2(lib)
    a = run_old(scene_tab, cam_tab, s0, s1, acc, pix, True, **kw)
    b = new_k2(scene_tab, cam_tab, s0, s1, acc, pix, True, **kw)
    print(f"  K2 complex783: acc max |new - old| {(a[2] - b[2]).abs().max().item():.3g}, "
          f"states equal {bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))}")
    turns(f"K2 complex783 {cs.WIDTH}x{cs.HEIGHT} x {cs.SPP} spp",
          lambda: run_old(scene_tab, cam_tab, s0, s1, acc, pix, True, **kw),
          lambda: new_k2(scene_tab, cam_tab, s0, s1, acc, pix, True, **kw))
    off = new_k2(scene_tab, cam_tab, s0, s1, acc, pix, False, **kw)
    print(f"  K2 complex783 8 spp: new cull on == new cull off bitwise: "
          f"{all(bool(torch.equal(x, y)) for x, y in zip(b, off))}")


def ab_k1(lib):
    import torch

    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    scene_tab, cam_tab, (s0, s1, acc), _, kw = cs.pass_inputs(
        cs.SCENE, cs.WIDTH, cs.HEIGHT, "pt", "mwc", "cuda")
    k1 = lambda: ptk.pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, num_samples=cs.SPP, **kw)  # noqa: E731

    def old_k1():
        with using(ptk, lib):
            return k1()

    a, b = old_k1(), k1()
    print(f"  K1 Cornell: new bitwise equal to old: "
          f"{all(bool(torch.equal(x, y)) for x, y in zip(a, b))}")
    turns(f"K1 Cornell {cs.WIDTH}x{cs.HEIGHT} x {cs.SPP} spp", old_k1, k1)


if __name__ == "__main__":
    sys.exit(main())
