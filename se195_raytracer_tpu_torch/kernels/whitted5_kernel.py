"""K4: the raytracer5 ("whitted5") tracer as a hand-written CUDA kernel
(``csrc/whitted5_kernel.cu``), twin of se195_raytracer_tpu/kernels/
whitted5_kernel.py.

The TPU package launches one Pallas kernel per tree level over node-major
[K*R] buffers and runs the texel fetch (K5), the color combine, Beer's
weights and the level concatenation in XLA between levels. K4 runs a whole
render pass, every level and every node, in one thread per primary ray, and
all passes of a render in one launch, with K5's fetch inside it.

``whitted5_trace_cuda`` takes the scene, the rays and the counter-RNG state
and returns what ``models/whitted5.trace_passes``, its plain version, returns:
the passes' color (mean or sum), the advanced state and, if asked, the
level-1 hit ids. CPU tensors take the plain version; a CUDA tensor launches
the kernel or raises. ``.launches`` counts the launches and
``.texel_launches`` those on a textured scene, where K5's fetch runs inside
K4 (K5's own entry, ``texel_kernel.texel_fetch_cuda``, counts its own).
Both refuse inputs that require grad (``kernels/_guard.py``): gradients
come from the plain tracer, ``use_kernel=False``.

K4 tests a box exactly only behind a rounding-aware slab prefilter, and
its shadow test runs the light's own candidate first and stops at the
first primitive that the first minimum would take instead.
``box_records``, ``box_slab_bounds``, ``shadow_visible`` and
``nearest_keeps`` are their torch mirror: test oracles and work counters,
never on the main path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.types import derived
from se195_raytracer_tpu_torch.kernels._guard import refuse_grad
from se195_raytracer_tpu_torch.kernels.texel_kernel import kernel_lib, pack_texel_units
from se195_raytracer_tpu_torch.models.whitted5 import (
    _EPS,
    AREA_SAMPLES_BY_LEVEL,
    MAX_DIST,
    PASS_DRAW_BUDGET,
    TRACEDEPTH5,
    _prim_candidates,
    _static_normals,
    samples_per_level,
    trace_passes,
)
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import BOX5, FIELDS, Whitted5Scene
from se195_raytracer_tpu_torch.utils.profiling import span

# Deepest tree the kernel's per-thread node slots hold (kMaxDepth).
MAX_TRACE_DEPTH = 5
# A block's shared memory on sm_90 once the kernel opts in past the default
# 48 KB, which K4's launch does for a scene that needs it.
_MAX_SMEM_BYTES = 227 * 1024
_M32 = 0xFFFFFFFF
# K4's box prefilter (kRel, kAbs, kFlat in csrc/whitted5_kernel.cu, which
# argues them): a computed slab distance t may be off by PREFILTER_REL * |t|,
# a computed hit point by PREFILTER_ABS * (2 M + |o|) on an axis whose box
# coordinates are at most M in magnitude and ray origin at o; a direction
# component below FLAT_DIR in magnitude is treated as zero.
PREFILTER_REL = 1e-6
PREFILTER_ABS = 1e-6
FLAT_DIR = 1e-30


def pack_whitted5_scene(scene: Whitted5Scene) -> torch.Tensor:
    """[27, N] float32 primitive table, bitwise the JAX package's: rows 0-2
    center, 3 radius, 4-6 normal, 7 depth, 8-10 box pos, 11-13 box size,
    14-16 color, 17 refl, 18 refr, 19 refr_index, 20 diff, 21 spec, 22 drefl,
    23-25 the static normal (plane normal or the position-free box normal),
    26 the guarded 1/radius."""
    rrad = 1.0 / torch.where(scene.radius != 0.0, scene.radius, 1.0)
    return torch.cat(
        [
            scene.center.T, scene.radius[None, :], scene.normal.T, scene.depth[None, :],
            scene.box_pos.T, scene.box_size.T, scene.color.T, scene.refl[None, :],
            scene.refr[None, :], scene.refr_index[None, :], scene.diff[None, :],
            scene.spec[None, :], scene.drefl[None, :], _static_normals(scene).T,
            rrad[None, :],
        ],
        dim=0,
    ).to(torch.float32).contiguous()


def _packed(scene: Whitted5Scene):
    """The scene's packed tables, made once per scene and kept
    (``derived``: its tensors and textures by identity and version, its
    static structure), so that a render makes no host-to-device copy once
    its scene is packed; in span ``w5.tables``, with ``w5.tables.build``
    inside it on a build."""

    def build():
        with span("w5.tables.build"):
            # Beside the [27, N] table: [3, N] int32 rows type, light flag and
            # texture id, the [2, N] uv scales and the texel units.
            aux = torch.tensor([list(scene.ptype), [int(x) for x in scene.is_light],
                                list(scene.tex_id)], dtype=torch.int32, device=scene.device)
            return (pack_whitted5_scene(scene), aux, scene.uv_scale.T.contiguous(),
                    pack_texel_units(scene.textures, scene.device))

    with span("w5.tables"):
        return derived("w5.tables", tuple(getattr(scene, f) for f in FIELDS) + scene.textures,
                       (scene.ptype, scene.is_light, scene.tex_id), build)


def box_records(scene: Whitted5Scene) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """(box indices, [B, 4, 3] float32 records (v1, v2, lo, hi)): the box's
    corners and its EPSILON-widened corners, v2 = v1 + size, lo = v1 - eps,
    hi = v2 + eps, the float32 sums K4 makes once per block from the [27, N]
    table and its exact box test uses."""
    boxes = tuple(j for j, t in enumerate(scene.ptype) if t == BOX5)
    v1 = scene.box_pos[list(boxes)].to(torch.float32)
    v2 = v1 + scene.box_size[list(boxes)].to(torch.float32)
    return boxes, torch.stack([v1, v2, v1 - _EPS, v2 + _EPS], dim=1)


def box_slab_bounds(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor,
                    margin: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's box prefilter in torch, op by op as the kernel rounds it: for
    rays [R, 3] against the boxes of ``box_records``, (lo_t, hi_t) [R, B]
    such that every face hit that K4's exact box test (``_prim_candidates``)
    counts lies at lo_t <= t <= hi_t. An empty interval (lo_t > hi_t), one
    that ends at or before 0, or a flat axis (|d_a| < FLAT_DIR) whose origin
    lies outside the widened slab, has no such hit (the interval is then
    (+inf, -inf)). ``margin`` scales the rounding margins: 1 as built, 0
    drops them (a mutation that must fail the tests)."""
    _, rec = box_records(scene)
    lo, hi = rec[:, 2], rec[:, 3]  # [B, 3]
    inf = float("inf")
    r, b = o.shape[0], lo.shape[0]
    flat = d.abs() < FLAT_DIR  # [R, 3]
    inv = 1.0 / torch.where(flat, 1.0, d)
    # The largest box coordinate magnitude, over every box and axis.
    big = float(torch.maximum(lo.abs(), hi.abs()).max()) if b else 0.0
    e = (2.0 * big + o.abs()) * float(np.float32(PREFILTER_ABS * margin))  # [R, 3]
    m = torch.where(flat, 0.0, e * inv.abs()).amax(dim=1)  # [R]
    tn = torch.full((r, b), -inf, device=o.device)
    tf = torch.full((r, b), inf, device=o.device)
    out = torch.zeros((r, b), dtype=torch.bool, device=o.device)
    for a in range(3):
        t1 = (lo[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t2 = (hi[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        fa = flat[:, a:a + 1]
        tn = torch.where(fa, tn, torch.fmax(tn, torch.fmin(t1, t2)))
        tf = torch.where(fa, tf, torch.fmin(tf, torch.fmax(t1, t2)))
        oa, ea = o[:, a:a + 1], e[:, a:a + 1]
        inside = (oa > lo[None, :, a] - ea) & (oa < hi[None, :, a] + ea)
        out = out | (fa & ~inside)
    rel = float(np.float32(PREFILTER_REL * margin))
    lo_t = tn - rel * tn.abs() - m[:, None]
    hi_t = tf + rel * tf.abs() + m[:, None]
    empty = out | ~(lo_t <= hi_t) | ~(hi_t > 0.0)
    return torch.where(empty, inf, lo_t), torch.where(empty, -inf, hi_t)


def shadow_visible(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor, max_t: torch.Tensor,
                   target: int, margin: float = 1.0, counts: Optional[dict] = None):
    """K4's shadow test in torch: the target's own candidate first (dark when
    it is invalid or not nearer than ``max_t``), then the other primitives,
    boxes behind the prefilter (``box_slab_bounds`` against the target's
    distance): a primitive j blocks where its candidate is valid and nearer,
    or as near and j < target, which is where ``_first_min``'s ascending,
    strict-< scan would take it. The result equals ``_nearest_is``. A test
    oracle. ``counts``, when a dict, gets ``sweeps`` and ``box_tests`` added
    to it: the exact box tests the kernel runs, the target's if a box and
    those the prefilter keeps (at most: the kernel stops at the first
    blocker)."""
    dist, _, valid = _prim_candidates(scene, o, d)
    n = dist.shape[1]
    d_t = dist[:, target]
    lit = valid[:, target] & (d_t < max_t)
    j = torch.arange(n, device=o.device)[None]
    blocks = valid & ((dist < d_t[:, None]) | ((dist == d_t[:, None]) & (j < target)))
    blocks[:, target] = False
    boxes, _ = box_records(scene)
    lo_t, _ = box_slab_bounds(scene, o, d, margin)
    keep = torch.ones_like(valid)
    if boxes:
        keep[:, list(boxes)] = ~(lo_t > d_t[:, None])
    keep[:, target] = True
    if counts is not None:
        box_cols = torch.zeros(n, dtype=torch.bool, device=o.device)
        box_cols[list(boxes)] = True
        tested = keep & box_cols[None] & lit[:, None]
        tested[:, target] = box_cols[target]
        counts["sweeps"] = counts.get("sweeps", 0) + o.shape[0]
        counts["box_tests"] = counts.get("box_tests", 0) + int(tested.sum())
    return lit & ~(blocks & keep).any(dim=1)


def nearest_keeps(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor, margin: float = 1.0,
                  counts: Optional[dict] = None):
    """K4's nearest sweep in torch: spheres and planes first, then the boxes
    in ascending order, each behind the prefilter against the running best
    (capped at MAX_DIST: a nearest hit at or beyond it is a miss whichever
    primitive it is); every candidate is taken on (dist, index) below the
    running (best, amin), which gives ``_first_min``'s result wherever the
    sweep hits. Returns (best [R], amin [R], keep [R, N]: the primitives it
    tests). A test oracle; ``counts`` gets ``sweeps`` and ``box_tests``."""
    dist, _, valid = _prim_candidates(scene, o, d)
    r, n = dist.shape
    boxes, _ = box_records(scene)
    lo_t, _ = box_slab_bounds(scene, o, d, margin)
    keep = torch.ones((r, n), dtype=torch.bool, device=o.device)
    best = torch.full((r,), float("inf"), device=o.device)
    amin = torch.full((r,), n, dtype=torch.int64, device=o.device)

    def take(j, ok):
        nonlocal best, amin
        dj = dist[:, j]
        win = ok & valid[:, j] & ((dj < best) | ((dj == best) & (j < amin)))
        best = torch.where(win, dj, best)
        amin = torch.where(win, torch.full_like(amin, j), amin)

    for j in range(n):
        if j not in boxes:
            take(j, keep[:, j])
    for k, j in enumerate(boxes):
        keep[:, j] = ~(lo_t[:, k] > torch.clamp(best, max=MAX_DIST))
        take(j, keep[:, j])
    if counts is not None:
        counts["sweeps"] = counts.get("sweeps", 0) + r
        counts["box_tests"] = counts.get("box_tests", 0) + int(keep[:, list(boxes)].sum())
    return best, torch.where(amin == n, 0, amin), keep


def shared_memory_bytes(n: int, n_tex: int) -> int:
    """Bytes of shared memory a K4 block holds for ``n`` primitives and
    ``n_tex`` textures (``smem_words`` in csrc/whitted5_kernel.cu: four
    float4 geometry records, the [27, n] table, the uv scales, three int
    rows and four index lists per primitive, four ints per texture (its
    ``pack_texel_units`` table row), eight words of counts); raises
    ValueError above what a block can hold."""
    smem = 4 * (52 * n + 4 * n_tex + 8)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{n} primitives need {smem} B of shared memory (> {_MAX_SMEM_BYTES})")
    return smem


def whitted5_trace_cuda(
    scene: Whitted5Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    state,
    *,
    spp: int = 1,
    mean: bool = True,
    trace_depth: int = TRACEDEPTH5,
    area_samples_by_level=AREA_SAMPLES_BY_LEVEL,
    return_primary_idx: bool = False,
):
    """``spp`` passes of the whitted5 tree for R primary rays, in one launch.

    ``o``/``d``: float32 [R, 3] (every pass traces them) or [spp, R, 3] (pass
    p traces set p, as the 4-ray render and the adaptive extra rays do);
    ``state``: (key, counter) [R] holding uint32 words. Pass p draws from
    counter + p * PASS_DRAW_BUDGET. Returns (color [R, 3] = the passes' sum,
    divided by spp when ``mean``; the state advanced by spp passes), plus the
    first pass's level-1 hit ids ([R] int32, -1 on a miss) when
    ``return_primary_idx``. CPU tensors take ``trace_passes``."""
    refuse_grad("whitted5_trace_cuda", scene, o, d)
    dev = scene.device
    r = o.shape[-2]
    n_sets = 1 if o.dim() == 2 else o.shape[0]
    if o.shape != d.shape or o.shape[-1] != 3 or o.dim() not in (2, 3) or n_sets not in (1, spp):
        raise ValueError(f"o, d: need [R, 3] or [{spp}, R, 3], got {tuple(o.shape)}, "
                         f"{tuple(d.shape)}")
    for name, t in (("o", o), ("d", d)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
    if state[0].shape != (r,) or state[1].shape != (r,):
        raise ValueError(f"state: need two [{r}] tensors")
    if dev.type == "cpu":
        return trace_passes(scene, o, d, state, spp=spp, mean=mean, trace_depth=trace_depth,
                            area_samples_by_level=area_samples_by_level,
                            return_primary_idx=return_primary_idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= trace_depth <= MAX_TRACE_DEPTH:
        raise ValueError(f"trace_depth {trace_depth} outside 1..{MAX_TRACE_DEPTH}")
    n = scene.num_prims
    shared_memory_bytes(n, len(scene.textures))
    table, aux, uvs, (units, textab) = _packed(scene)
    o, d = o.contiguous(), d.contiguous()
    key, ctr = (s.to(torch.uint32).contiguous() for s in state)
    nsamp = samples_per_level(trace_depth, area_samples_by_level)
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev) if return_primary_idx else None
    err = kernel_lib().whitted5_trace_cuda(
        table.data_ptr(), uvs.data_ptr(), aux.data_ptr(), n, units.data_ptr(),
        textab.data_ptr(), textab.shape[0], o.data_ptr(), d.data_ptr(), n_sets, r,
        key.data_ptr(), ctr.data_ptr(), spp, trace_depth,
        (ctypes.c_int * len(nsamp))(*nsamp), float(spp if mean else 1),
        out.data_ptr(), None if idx is None else idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"whitted5_trace_cuda launch failed: cudaError {err}")
    whitted5_trace_cuda.launches += 1
    if any(t >= 0 for t in scene.tex_id):
        # K5's fetch ran inside this launch.
        whitted5_trace_cuda.texel_launches += 1
    new_state = (state[0].to(torch.int64),
                 (state[1].to(torch.int64) + spp * PASS_DRAW_BUDGET) & _M32)
    return (out, new_state, idx) if return_primary_idx else (out, new_state)


whitted5_trace_cuda.launches = 0
# Launches of K4 on a textured scene, each of which runs K5's device fetch.
whitted5_trace_cuda.texel_launches = 0
