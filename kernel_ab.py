"""A/B of the port's hand-written kernels against the sources of the parent
commit, on one GPU, in one process.

    mkdir -p _archive/parent
    for f in pt_kernel whitted_kernel whitted5_kernel; do
      git show 0518b77:se195_raytracer_tpu_torch/kernels/csrc/$f.cu > _archive/parent/$f.cu
    done
    python3 kernel_ab.py [--old _archive/parent] [--old-args flat|units]
                         [--kernels K1 ... K5] [--splits K2 K3 K4]

Builds the current sources (``kernels/_build.py``) and the old ones (same
nvcc flags, into ``<old>/_build/``), prints each kernel's ptxas registers,
stack frame and spills and whether its SASS (``cuobjdump -sass``) is the
old one's instruction for instruction, then times each kernel in turns (old, new, new,
old; CUDA events around back-to-back launches, median of 5 after a
warm-up) at the shapes of chip_smoke.py's main paths: K5 alone on its
three lane sets (2^18 and 2^22 random lanes, K4's own fetches at room5
800x600 spp 1) in both texture forms (the procedural room5 textures and
u8/256 200x200 TGA ones), K4 on room5 800x600 spp 8 with each of the two
texture sets, K1 on Cornell 512x512 x 8 spp (PT/mwc and DL/mwc timed;
PT/counter compared too), K2 on complex783 512x512 x 8 spp, K3 on the
Whitted room frame (800x600, 3x3, depth 5). Old and new outputs are
compared bitwise (K2 also cull on against cull off; K3 through both entries
on room and grid at hit_bias 0 and 0.005); K2's two versions are
also held to the plain version (chip_smoke.py's K2 contract, 1 spp) on
complex783 and the 3,908-sphere ``complex_scene(max_depth=5)``, and timed
on the latter at 512x512 x 1 spp.

The old sources run through the current wrappers, so their C entry
points must take the current arguments, with one exception made
explicit: sources from before K5's texel units (the parent commit
0518b77 and earlier) take the [texels, 3] float32 atlas and its [T, 3]
table where the current K4 and K5 entries take the texel units and their
[T, 4] table. ``--old-args flat`` (the default, for the parent) hands them
those (``FlatAtlasLib``); ``--old-args units`` runs a copy of the current
sources as it is. K3's frame entry in sources whose kernel reads the camera
row through a device pointer (no ``CamRow`` in the source) gets the row
copied to the card first (``DeviceCamLib``), where the current entry takes
it from host memory.

``--old`` defaults to ``_archive/parent`` (git-ignored), which the lines
above fill with the parent commit's sources; without it only the current
sources are built. Any other copy of the three sources is A/B'd the same
way: a variant of a kernel (another block size, say) is a copy with the
change made by hand, run with ``--old`` pointing at it and ``--old-args
units``. ``--kernels`` limits the A/B to the named kernels. ``--splits``
prints chip_smoke.py's split lines of the named kernels, for both versions
when there is an old one. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import re
import statistics
import subprocess
import sys
import tempfile
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
    # A copy of the current sources also builds K2's own library.
    names = SOURCES + (("pt_blocked_kernel",) if (src_dir / "pt_blocked_kernel.cu").exists()
                       else ())
    for name in names:
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

    current = {"pt_kernel": ptk._kernel_lib(), "pt_blocked_kernel": ptk._k2_lib(),
               "whitted_kernel": wk._kernel_lib(), "whitted5_kernel": tk.kernel_lib()}
    libs, logs = {}, {}
    for name, (proc, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{logs[name]}")
        lib = libs[name] = ctypes.CDLL(str(out))
        for fn in ("pt_multi_pass_cuda", "pt_blocked_pass_cuda", "whitted_trace_cuda",
                   "whitted_frame_cuda", "whitted_taps_cuda", "whitted5_trace_cuda",
                   "texel_fetch_cuda"):
            if hasattr(current[name], fn) and hasattr(lib, fn):
                getattr(lib, fn).argtypes = getattr(current[name], fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
    return libs, logs


def sass_sections(path: Path):
    """{function: its SASS text} of a built library (``cuobjdump -sass``).
    The hashes nvcc puts in the anonymous namespace's name (of the source's
    path) are cut from names and text, so that two builds of one source
    from two directories compare."""
    from se195_raytracer_tpu_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}", r"\1\2", text)
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {parts[i]: parts[i + 1].strip() for i in range(1, len(parts) - 1, 2)}


def compare_sass(new_path: Path, old_path: Path, source: str):
    """Prints, for each kernel in both libraries, whether its SASS is the
    same instruction for instruction: code that a change left alone."""
    new, old = sass_sections(new_path), sass_sections(old_path)
    for fn in sorted(new.keys() & old.keys()):
        same = new[fn] == old[fn]
        print(f"  SASS {source} {fn}: {'identical to old' if same else 'DIFFERS from old'} "
              f"({new[fn].count(chr(10)) + 1} lines new, {old[fn].count(chr(10)) + 1} old)")
    for fn in sorted(new.keys() - old.keys()):
        print(f"  SASS {source} {fn}: new kernel")


class FlatAtlasLib:
    """The K4 and K5 entry points of sources from before the texel units,
    with their own argument list: argument 4 of ``whitted5_trace_cuda`` and
    argument 0 of ``texel_fetch_cuda`` take the [texels, 3] float32 atlas of
    ``textures`` and the next one its [T, 3] (texel offset, th, tw) table
    (``texel_kernel.pack_texel_atlas``), where the current wrappers pass the
    texel units and their [T, 4] table. Every other argument is the same."""

    def __init__(self, lib, textures):
        from se195_raytracer_tpu_torch.kernels import texel_kernel as tk

        self.lib = lib
        self.atlas, self.textab = tk.pack_texel_atlas(textures)

    def whitted5_trace_cuda(self, *args):
        args = list(args)
        args[4:6] = [self.atlas.data_ptr(), self.textab.data_ptr()]
        return self.lib.whitted5_trace_cuda(*args)

    def texel_fetch_cuda(self, *args):
        return self.lib.texel_fetch_cuda(self.atlas.data_ptr(), self.textab.data_ptr(),
                                         *args[2:])


class DeviceCamLib:
    """K3's entry points of sources whose frame kernel takes the camera row
    as a device pointer: argument 5 of ``whitted_frame_cuda``, which the
    current wrapper passes as the address of 12 host floats, is copied to
    the card for them (a synchronous copy). Every other entry is the old
    library's own."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def whitted_frame_cuda(self, *args):
        import torch

        args = list(args)
        cam = torch.tensor(list((ctypes.c_float * 12).from_address(args[5])), device="cuda")
        args[5] = cam.data_ptr()
        return self.lib.whitted_frame_cuda(*args)


def k3_lib(lib, old_dir: Path):
    """The old whitted_kernel library as the current wrappers call it."""
    source = (old_dir / "whitted_kernel.cu").read_text()
    return lib if "CamRow" in source else DeviceCamLib(lib)


def k45_lib(lib, textures, old_args):
    """The old whitted5_kernel library as the current wrappers call it, for a
    scene with ``textures``."""
    return FlatAtlasLib(lib, textures) if old_args == "flat" else lib


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
    from se195_raytracer_tpu_torch.models.whitted import whitted_camera_rays_device
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    room = WHITTED_SCENES["room"]("cuda")
    frame = lambda: wk.whitted_frame_cuda(room, **WHITTED)  # noqa: E731

    def old_frame():
        with using(wk, lib):
            return frame()

    print(f"  K3 room frame: new bitwise equal to old: {equal([old_frame()], [frame()])}")
    # Both entries on both scenes and hit_bias values, old against new.
    w, h, ss, depth = (WHITTED[k] for k in ("width", "height", "supersample", "trace_depth"))
    tiles = wk.rays_to_tiles(*whitted_camera_rays_device(w, h, ss, device="cuda"))
    for name in ("room", "grid"):
        scene = WHITTED_SCENES[name]("cuda")
        for bias in (0.0, 0.005):
            runs = {}
            for tag in ("old", "new"):
                with using(wk, lib) if tag == "old" else contextlib.nullcontext():
                    runs[tag] = [wk.whitted_frame_cuda(scene, hit_bias=bias, **WHITTED),
                                 wk.whitted_trace_cuda(scene, tiles, trace_depth=depth,
                                                       hit_bias=bias)]
            print(f"  K3 {name} hit_bias {bias}: frame and explicit-ray entries, new bitwise "
                  f"equal to old: {equal(runs['old'], runs['new'])}")
    turns("K3 room 800x600 3x3 depth 5", old_frame, frame, timer=lambda fn: cs.launch_ms(fn, n=10))


def ab_k2(lib):
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene

    scene_tab, cam_tab, (s0, s1, acc), pix, kw = cs.pass_inputs(
        cs.COMPLEX, cs.WIDTH, cs.HEIGHT, "pt", "mwc", "cuda")
    kw["num_samples"] = cs.SPP

    def k2(cull=True):
        return ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, cull=cull, **kw)

    def old_k2():
        with using(ptk, lib, "_k2_lib"):
            return k2()

    new = k2()
    print(f"  K2 complex783 8 spp: new bitwise equal to old: {equal(old_k2(), new)}; new cull "
          f"on == new cull off: {equal(new, k2(cull=False))}")
    turns(f"K2 complex783 {cs.WIDTH}x{cs.HEIGHT} x {cs.SPP} spp", old_k2, k2,
          timer=lambda fn: cs.launch_ms(fn, n=5))
    # Each version against the plain version (chip_smoke.py's contract:
    # state mismatch <= 1%), on complex783 and the 3,908-sphere scene.
    big = complex_scene(max_depth=5.0)
    for name, spec in (("complex783", cs.get_spec(cs.COMPLEX)), ("complex3908", big)):
        for which in ("old", "new"):
            with using(ptk, lib, "_k2_lib") if which == "old" else contextlib.nullcontext():
                mism, st_mism, mean, plain_mean = cs.k2_against_plain(spec)
            print(f"  K2 {which} {name} 1 spp against its plain version: mismatch {mism:.4%}, "
                  f"state mismatch {st_mism:.4%}, mean {mean:.6f} vs {plain_mean:.6f}")
    tab, camt, st, pix, kw = cs.pass_inputs(big, cs.WIDTH, cs.HEIGHT, "pt", "mwc", "cuda")
    k2_big = lambda: ptk.pt_blocked_pass(tab, camt, 0, *st, pix, num_samples=1, **kw)  # noqa: E731

    def old_big():
        with using(ptk, lib, "_k2_lib"):
            return k2_big()

    turns(f"K2 complex3908 {cs.WIDTH}x{cs.HEIGHT} x 1 spp", old_big, k2_big,
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


def ab_k5(lib, old_args, tmp):
    """K5 alone, old against new, on each lane set in each texture form."""
    import torch

    from se195_raytracer_tpu_torch.kernels import texel_kernel as tk

    atlases = cs.k5_atlases(tmp)
    w, h = cs.W5_SIZES[-1]
    sets = cs.k5_lane_sets(cs.k4_texel_stream(atlases["f32"], w, h))
    for form, scene in atlases.items():
        layout = tk.pack_texel_units(scene.textures)
        flat, textab = tk.pack_texel_atlas(scene.textures)
        old_lib = k45_lib(lib, scene.textures, old_args)
        for label, (tex, u, v) in sets.items():
            live = torch.ones_like(u, dtype=torch.bool)

            def new(tex=tex, u=u, v=v, live=live):
                return tk.texel_fetch_cuda(flat, textab, tex, u, v, live, layout=layout)

            def old(new=new):
                with using(tk, old_lib, "kernel_lib"):
                    return new()

            tag = f"K5 {form} {label} ({u.shape[0]} lanes)"
            print(f"  {tag}: new bitwise equal to old: {equal([new()], [old()])}")
            turns(f"{tag}, device time", old, new,
                  timer=lambda fn: (cs.device_ms(fn, "texel_fetch_kernel"), None))
            turns(f"{tag}, back-to-back launches", old, new,
                  timer=lambda fn: cs.launch_ms(fn, n=20))


def ab_k4(lib, old_args, tmp):
    """K4 at room5 800x600 spp 8, old against new, with each texture set
    (and the 4-ray render on the procedural one), and K5's share of each:
    K4 against the scene's twin without texture ids, which fetches
    nothing, through the same library."""
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k

    for form, scene in cs.k5_atlases(tmp).items():
        spp8, four, label = k4_calls(scene)
        twin = dataclasses.replace(scene, tex_id=tuple(-1 for _ in scene.tex_id))
        bare = k4_calls(twin)[0]
        old_lib = k45_lib(lib, scene.textures, old_args)

        def old(fn, old_lib=old_lib):
            with using(w5k, old_lib, "kernel_lib"):
                return fn()

        line = f"  {label} ({form} textures): new bitwise equal to old: colour and primary ids " \
               f"{equal(spp8(), old(spp8))}"
        if form == "f32":
            line += f"; 4-ray colour {equal(four(), old(four))}"
        print(line)
        timer = lambda fn: cs.launch_ms(fn, n=5)  # noqa: E731
        with_old, with_new = turns(f"{label} ({form} textures)", lambda: old(spp8), spp8,
                                   timer=timer)
        bare_old, bare_new = turns(f"{label} (no texture ids)", lambda: old(bare), bare,
                                   timer=timer)
        print(f"  K5's share of K4 ({form} textures): old {1 - bare_old / with_old:.2%}, new "
              f"{1 - bare_new / with_new:.2%}")


def k4_calls(scene):
    """(spp-8 call, 4-ray call, label): K4 on ``scene`` at room5 800x600
    through whitted5_trace_cuda, the spp-8 one with the primary ids."""
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P

    w, h = cs.W5_SIZES[-1]
    o, d = P._cached_rays5(w, h, (0.5, 0.5), "cuda")
    o4, d4 = P._cached_rays5_4(w, h, "cuda")
    state = P._state5(w * h, cs.W5_SEED, "cuda")

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
    ap.add_argument("--old-args", choices=("flat", "units"), default="flat",
                    help="the old K4/K5 entries' texture arguments: flat (the parent's "
                         "[texels, 3] atlas) or units (a copy of the current sources)")
    ap.add_argument("--kernels", nargs="*", choices=("K1", "K2", "K3", "K4", "K5"),
                    default=("K1", "K2", "K3", "K4", "K5"), help="A/B these kernels")
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
        old["whitted_kernel"] = k3_lib(old["whitted_kernel"], args.old)
        cs.print_ptxas(logs, "old ")
        from se195_raytracer_tpu_torch.kernels._build import library_path

        for name in SOURCES:
            compare_sass(library_path(name), args.old / "_build" / f"{name}.so", name)
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
                room5 = S.WHITTED5_SCENES["room5"]("cuda")
                stack.enter_context(using(w5k, k45_lib(old["whitted5_kernel"], room5.textures,
                                                       args.old_args), "kernel_lib"))
            if "K3" in args.splits:
                cs.k3_split(WHITTED_SCENES["room"]("cuda"), w, h, k3_works)
            if "K2" in args.splits:
                cs.k2_split(cs.WIDTH, cs.HEIGHT, cs.SPP, k2_works)
            if "K4" in args.splits:
                w5, h5 = cs.W5_SIZES[-1]
                cs.k4_split(S.WHITTED5_SCENES["room5"]("cuda"), w5, h5, k4_works)
    if old:
        print("[A/B] old, new, new, old")
        with tempfile.TemporaryDirectory() as tmp:
            cs.write_u8_textures(tmp)
            for kernel, fn in (("K5", ab_k5), ("K4", ab_k4)):
                if kernel in args.kernels:
                    fn(old["whitted5_kernel"], args.old_args, tmp)
        # K2's old library: its own build where the old sources have one
        # (pt_blocked_kernel.cu), else pt_kernel's.
        k2_old = "pt_blocked_kernel" if "pt_blocked_kernel" in old else "pt_kernel"
        for kernel, fn, source in (("K1", ab_k1, "pt_kernel"), ("K2", ab_k2, k2_old),
                                   ("K3", ab_k3, "whitted_kernel")):
            if kernel in args.kernels:
                fn(old[source])
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
