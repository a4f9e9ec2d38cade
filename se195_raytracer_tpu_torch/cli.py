"""Command-line interface (twin of se195_raytracer_tpu/cli.py for the
smallpt and Whitted families):

    python -m se195_raytracer_tpu_torch.cli render --scene cornell \
        --width 512 --height 512 --spp 8 --integrator pt --out out.png
    python -m se195_raytracer_tpu_torch.cli render --integrator whitted \
        --scene room --width 800 --height 600 --out room.png
    python -m se195_raytracer_tpu_torch.cli render --integrator whitted5 \
        --width 800 --height 600 --spp 8 [--adaptive] --out room5.png
    python -m se195_raytracer_tpu_torch.cli scenes

Renders run on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

# Per-integrator default scene (reference defaults: Cornell for smallpt,
# the 17-prim room for 3.2.0x, Scene::InitScene's room for raytracer5).
DEFAULT_SCENE = {"pt": "cornell", "dl": "cornell", "whitted": "room", "whitted5": "room5"}


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
    import numpy as np
    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.io.image import write_image
    from se195_raytracer_tpu_torch.scenes.registry import SCENES, list_scenes

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
    if args.integrator in ("pt", "dl") and scene_name not in SCENES:
        print(
            f"error: unknown scene {scene_name!r} (known: {', '.join(list_scenes())}); "
            "the .scn parser is not yet ported",
            file=sys.stderr,
        )
        return 2
    cfg = RenderConfig(
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
    t0 = time.perf_counter()
    if args.integrator == "whitted":
        from se195_raytracer_tpu_torch.models.whitted import render_whitted

        scene = _whitted_scene(scene_name, args.device)
        if scene is None:
            return 2
        img = render_whitted(scene, cfg, device=args.device)
        img_u8 = np.clip(img.cpu().numpy(), 0, 255).astype(np.uint8)
        rays = args.width * args.height * args.supersample ** 2
        what = f"ss={args.supersample}"
    elif args.integrator == "whitted5":
        img_u8 = _render_whitted5(args, scene_name)
        if img_u8 is None:
            return 2
        rays = args.width * args.height * (1 if args.adaptive else args.spp)
        what = "adaptive" if args.adaptive else f"spp={args.spp}"
    else:
        from se195_raytracer_tpu_torch.driver.render import render
        from se195_raytracer_tpu_torch.ops.tonemap import to_srgb_bytes
        from se195_raytracer_tpu_torch.scenes.registry import get_scene

        spec = get_scene(scene_name)
        img, _ = render(spec.to_scene(args.device), spec.to_camera(args.device), cfg,
                        device=args.device)
        img_u8 = to_srgb_bytes(img).cpu().numpy()
        rays = args.width * args.height * args.spp
        what = f"spp={args.spp}"
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


def cmd_scenes(_args) -> int:
    from se195_raytracer_tpu_torch.scenes.registry import list_scenes

    for name in list_scenes():
        print(name)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="se195-render-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to an image file")
    p.add_argument("--scene", default=None,
                   help="registry name (default: per integrator, cornell / room / room5)")
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
    p.add_argument("--out", default="out.png", help=".png/.ppm/.bmp path ('' to skip)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("scenes", help="list built-in scenes")
    p.set_defaults(fn=cmd_scenes)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
