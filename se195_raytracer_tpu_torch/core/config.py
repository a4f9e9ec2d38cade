"""Typed render configuration (twin of se195_raytracer_tpu/core/config.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 640
    height: int = 480  # reference defaults: displayfunc.cpp:61-62
    spp: int = 1  # samples per pixel (progressive passes)
    # Bounce budget. The reference runs the bounce body for depth = 0..6
    # inclusive (geomfunc.h:182-187 terminates when depth > 6), i.e. 7
    # iterations; max_depth counts body iterations.
    max_depth: int = 7
    integrator: str = "pt"  # "pt" (RadiancePathTracing) | "dl" (DirectLighting)
    # "mwc" (reference-exact multiply-with-carry) | "counter" (SplitMix-style
    # hash of (per-pixel key, draw counter), core/rng.py counter_next)
    rng: str = "mwc"
    seed: int = 0
    # Rays processed per inner chunk of the plain path; bounds the
    # [rays, spheres] working set. None = whole image at once.
    ray_tile: Optional[int] = None
    # Run the hand-written CUDA kernel path (kernels/pt_kernel.render_cuda);
    # False runs the plain PyTorch integrator (driver/render.render_steps).
    use_kernel: bool = True
    # Whitted-family (3.2.0x) knobs, read by models/whitted.render_whitted.
    # Defaults are the reference's compile-time constants
    # (raytracer_kernel.cl:8 TRACEDEPTH 5, :291-292 3x3 supersampling);
    # hit_bias 0.005 is the 3.2.03 near-hit slack (:128), 0.0 the
    # 3.2.02/CPU semantics.
    supersample: int = 3
    trace_depth: int = 5
    hit_bias: float = 0.0
    # The raytracer5 family (models/whitted5.py) takes its knobs as keyword
    # arguments, not from this class: width, height, spp, seed, use_kernel
    # and soft_edges mean the same there; its trace depth is TRACEDEPTH5 = 4
    # (the CLI's --trace-depth is the 3.2.0x knob).
    # Differentiable-visibility relaxation width in world units (0 = the
    # reference's hard estimator). The plain path renders the relaxed
    # estimator (models/smallpt.py); the kernels implement the hard one, so
    # > 0 with use_kernel raises at render time.
    soft_edges: float = 0.0

    def __post_init__(self):
        if self.integrator not in ("pt", "dl"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.rng not in ("mwc", "counter"):
            raise ValueError(f"unknown rng {self.rng!r}")
