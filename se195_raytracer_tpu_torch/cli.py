"""Command-line interface (twin of se195_raytracer_tpu/cli.py), installed as
``se195-render-torch``:

    se195-render-torch render --scene cornell --width 512 --height 512 \
        --spp 8 --integrator pt --out out.png
    se195-render-torch render --scene tests/fixtures/scenes/caustic.scn ...
    se195-render-torch render --integrator whitted --scene room \
        --width 800 --height 600 --out room.png
    se195-render-torch render --integrator whitted5 --width 800 \
        --height 600 --spp 8 [--adaptive] --out room5.png
    se195-render-torch bench --scene cornell --width 512 --height 512 --spp 8
    se195-render-torch scenes

Renders run on the CUDA device unless ``--device cpu`` is given.
``--profile DIR`` writes a torch.profiler trace of the render (or of the
timed bench repetitions) into DIR.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# Per-integrator default scene (reference defaults: Cornell for smallpt,
# the 17-prim room for 3.2.0x, Scene::InitScene's room for raytracer5).
DEFAULT_SCENE = {"pt": "cornell", "dl": "cornell", "whitted": "room", "whitted5": "room5"}


def _load_scene(name: str):
    """The smallpt scene ``name``: a registry name first, then a ``.scn``
    file; None, with an error printed, when it is neither."""
    import os

    from se195_raytracer_tpu_torch.scenes.parser import load_scn
    from se195_raytracer_tpu_torch.scenes.registry import SCENES, get_scene, list_scenes

    if name in SCENES:
        return get_scene(name)
    if os.path.exists(name):
        return load_scn(name)
    print(f"error: unknown scene {name!r} — not a registry name "
          f"({', '.join(list_scenes())}) and no such file", file=sys.stderr)
    return None


def _whitted_scene(name: str, device):
    """The named Whitted (3.2.0x) scene, or None with an error printed."""
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    if name not in WHITTED_SCENES:
        print(f"error: unknown whitted scene {name!r} (known: {', '.join(sorted(WHITTED_SCENES))})",
              file=sys.stderr)
        return None
    return WHITTED_SCENES[name](device)


def _render_whitted5(args, scene_name):
    """The raytracer5 family: the brute render (trace depth 4, ``--spp``
    passes) or, with ``--adaptive``, adaptive 1-vs-4-ray supersampling.
    Returns the [H, W, 3] u8 image, or None with an error printed."""
    import numpy as np

    from se195_raytracer_tpu_torch.models.whitted5 import (
        render_whitted5,
        render_whitted5_adaptive,
    )
    from se195_raytracer_tpu_torch.scenes.whitted5_scenes import WHITTED5_SCENES

    if scene_name not in WHITTED5_SCENES:
        print(f"error: unknown whitted5 scene {scene_name!r} "
              f"(known: {', '.join(sorted(WHITTED5_SCENES))})", file=sys.stderr)
        return None
    scene = WHITTED5_SCENES[scene_name](args.device)
    kw = dict(width=args.width, height=args.height, seed=args.seed, use_kernel=args.kernel,
              device=args.device)
    if args.soft > 0.0:
        # The relaxation runs on the plain tracer: K4 is the hard estimator.
        kw.update(use_kernel=False, soft_edges=args.soft)
    if args.adaptive:
        img, frac = render_whitted5_adaptive(scene, **kw)
        print(f"adaptive supersampling: {frac * 100:.1f}% edge pixels got 4 rays",
              file=sys.stderr)
    else:
        img = render_whitted5(scene, spp=args.spp, **kw)
    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def cmd_render(args) -> int:
    import torch

    from se195_raytracer_tpu_torch.io.image import write_image
    from se195_raytracer_tpu_torch.utils.profiling import maybe_trace

    scene_name = args.scene or DEFAULT_SCENE[args.integrator]
    if args.adaptive and args.integrator != "whitted5":
        print("error: --adaptive is for --integrator whitted5", file=sys.stderr)
        return 2
    if args.soft > 0.0 and args.adaptive:
        print("error: --soft is not available with --adaptive (the adaptive renderer runs "
              "the hard estimator only)", file=sys.stderr)
        return 2
    if args.soft > 0.0 and args.integrator == "whitted":
        print("error: --soft is for --integrator pt, dl or whitted5", file=sys.stderr)
        return 2
    if args.soft > 0.0:
        print("--soft: rendering on the plain PyTorch path (the kernels implement the hard "
              "estimator)", file=sys.stderr)
    spec = None
    if args.integrator in ("pt", "dl"):
        spec = _load_scene(scene_name)
        if spec is None:
            return 2
    cfg = _config(args)
    t0 = time.perf_counter()
    with maybe_trace(args.profile):
        img_u8, rays, what = _render_u8(args, scene_name, spec, cfg)
    if img_u8 is None:
        return 2
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    print(
        f"rendered {scene_name} {args.width}x{args.height} {what} "
        f"in {elapsed:.3f}s ({rays / elapsed / 1e3:.1f}K samples/sec)",
        file=sys.stderr,
    )
    if args.out:
        write_image(img_u8, args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _config(args):
    from se195_raytracer_tpu_torch.core.config import RenderConfig

    return RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_depth=args.max_depth,
        integrator=args.integrator if args.integrator in ("pt", "dl") else "pt",
        seed=args.seed,
        ray_tile=args.ray_tile,
        use_kernel=args.kernel and args.soft == 0.0,
        supersample=args.supersample,
        trace_depth=args.trace_depth,
        hit_bias=args.hit_bias,
        soft_edges=args.soft,
    )


def _render_u8(args, scene_name, spec, cfg):
    """(u8 image, primary rays, label) of the render args ask for; the image
    is None when the scene is unknown (an error is printed)."""
    import numpy as np

    if args.integrator == "whitted":
        from se195_raytracer_tpu_torch.models.whitted import render_whitted

        scene = _whitted_scene(scene_name, args.device)
        if scene is None:
            return None, 0, ""
        img = render_whitted(scene, cfg, device=args.device)
        img_u8 = np.clip(img.cpu().numpy(), 0, 255).astype(np.uint8)
        return img_u8, args.width * args.height * args.supersample ** 2, f"ss={args.supersample}"
    if args.integrator == "whitted5":
        img_u8 = _render_whitted5(args, scene_name)
        rays = args.width * args.height * (1 if args.adaptive else args.spp)
        return img_u8, rays, "adaptive" if args.adaptive else f"spp={args.spp}"
    from se195_raytracer_tpu_torch.driver.render import render
    from se195_raytracer_tpu_torch.ops.tonemap import to_srgb_bytes

    img, _ = render(spec.to_scene(args.device), spec.to_camera(args.device), cfg,
                    device=args.device)
    img_u8 = to_srgb_bytes(img).cpu().numpy()
    return img_u8, args.width * args.height * args.spp, f"spp={args.spp}"


def _bench_run(args, scene_name, spec, cfg):
    """(a call that renders the bench's workload to a host array, or
    returns None when the whitted5 scene is unknown; its primary rays per
    call; its supersample factor, None for smallpt), or None when the
    Whitted scene is unknown."""
    if args.integrator == "whitted":
        from se195_raytracer_tpu_torch.models.whitted import render_whitted

        scene = _whitted_scene(scene_name, args.device)
        if scene is None:
            return None
        ss = args.supersample
        return (lambda: render_whitted(scene, cfg, device=args.device).cpu(),
                args.width * args.height * ss * ss, ss)
    if args.integrator == "whitted5":
        ss = 2 if args.adaptive else 1
        return (lambda: _render_whitted5(args, scene_name),
                args.width * args.height * ss * ss, ss)
    from se195_raytracer_tpu_torch.driver.render import render

    scene, camera = spec.to_scene(args.device), spec.to_camera(args.device)
    return (lambda: render(scene, camera, cfg, device=args.device)[0].cpu(),
            args.width * args.height * args.spp, None)


def cmd_bench(args) -> int:
    """Time ``--reps`` renders after a warm-up, print one JSON line: the
    smallpt keys ``scene``, ``width``, ``height``, ``spp``, ``integrator``,
    ``device``, ``elapsed_s`` (the best rep) and ``rays_per_sec``; the
    Whitted families give ``supersample`` in place of ``spp``, as the JAX
    CLI does."""
    import torch

    from se195_raytracer_tpu_torch.core.types import resolve_device
    from se195_raytracer_tpu_torch.utils.profiling import maybe_trace

    scene_name = args.scene or DEFAULT_SCENE[args.integrator]
    spec = None
    if args.integrator in ("pt", "dl"):
        spec = _load_scene(scene_name)
        if spec is None:
            return 2
    device = resolve_device(args.device)
    run = _bench_run(args, scene_name, spec, _config(args))
    # The warm-up builds the kernels and fills the caches.
    if run is None or run[0]() is None:
        return 2
    fn, rays, ss = run
    best = float("inf")
    with maybe_trace(args.profile):
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    rec = {"scene": scene_name, "width": args.width, "height": args.height}
    rec.update({"spp": args.spp} if ss is None else {"supersample": ss})
    rec.update({
        "integrator": args.integrator,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "elapsed_s": round(best, 4),
        "rays_per_sec": round(rays / best, 1),
    })
    print(json.dumps(rec))
    return 0


def cmd_scenes(_args) -> int:
    from se195_raytracer_tpu_torch.scenes.registry import list_scenes

    for name in list_scenes():
        print(name)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="se195-render-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to an image file")
    _add_render_args(p)
    p.add_argument("--out", default="out.png", help=".png/.ppm/.bmp path ('' to skip)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="benchmark a workload, print one JSON line")
    _add_render_args(p)
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("scenes", help="list built-in scenes")
    p.set_defaults(fn=cmd_scenes)

    args = parser.parse_args(argv)
    return args.fn(args)


def _add_render_args(p: argparse.ArgumentParser):
    p.add_argument("--scene", default=None,
                   help="registry name or .scn path (default: per integrator, cornell / "
                   "room / room5; a .scn file is for pt/dl)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=7)
    p.add_argument(
        "--integrator",
        choices=["pt", "dl", "whitted", "whitted5"],
        default="pt",
        help="pt=RadiancePathTracing, dl=RadianceDirectLighting, "
        "whitted=Whitted reflect/refract tree (3.2.0x), whitted5=extended Whitted "
        "(area lights, boxes, glossy, textures; raytracer5)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ray-tile", type=int, default=None)
    p.add_argument("--supersample", type=int, default=3,
                   help="whitted: subpixel rays per axis (reference 3x3, "
                   "raytracer_kernel.cl:291-292)")
    p.add_argument("--trace-depth", type=int, default=5,
                   help="whitted: reflect/refract tree depth (TRACEDEPTH 5, "
                   "raytracer_kernel.cl:8)")
    p.add_argument("--hit-bias", type=float, default=0.0,
                   help="whitted: 3.2.03 sphere near-hit slack (0.005, "
                   "raytracer_kernel.cl:128); default 0 = 3.2.02/CPU")
    p.add_argument("--adaptive", action="store_true",
                   help="whitted5: adaptive 1-vs-4-ray supersampling (raytracer5 "
                   "Engine::Render, raytracer.cpp:481-535)")
    p.add_argument("--soft", type=float, default=0.0, metavar="W",
                   help="differentiable-visibility relaxation width in world units (0 = "
                   "the reference's hard estimator). pt/dl: softens the emissive-hit and "
                   "shadow indicators; whitted5: softens the shadow visibility. W > 0 renders "
                   "on the plain PyTorch path (the kernels implement the hard estimator); "
                   "not with --adaptive or whitted")
    p.add_argument(
        "--kernel",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="run the passes in the CUDA kernels (on the CPU: their plain "
        "versions); --no-kernel runs the plain PyTorch integrators",
    )
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler trace of the render (bench: of the timed "
                   "repetitions) to DIR/trace.json (Perfetto, chrome://tracing)")


if __name__ == "__main__":
    sys.exit(main())
