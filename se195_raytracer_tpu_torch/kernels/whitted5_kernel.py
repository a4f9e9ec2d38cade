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
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from se195_raytracer_tpu_torch.kernels.texel_kernel import kernel_lib, pack_texel_atlas
from se195_raytracer_tpu_torch.models.whitted5 import (
    AREA_SAMPLES_BY_LEVEL,
    PASS_DRAW_BUDGET,
    TRACEDEPTH5,
    _static_normals,
    samples_per_level,
    trace_passes,
)
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import Whitted5Scene

# Deepest tree the kernel's per-thread node slots hold (kMaxDepth).
MAX_TRACE_DEPTH = 5
_MAX_SMEM_BYTES = 48 * 1024
_M32 = 0xFFFFFFFF


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


def pack_whitted5_aux(scene: Whitted5Scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """([3, N] int32 rows type, light flag, texture id; [2, N] float32 uv
    scales), the per-primitive tables K4 keeps beside the [27, N] one."""
    aux = torch.tensor([list(scene.ptype), [int(x) for x in scene.is_light], list(scene.tex_id)],
                       dtype=torch.int32, device=scene.device)
    return aux, scene.uv_scale.T.contiguous()


# The packed tables of the last few scenes, by id, with the scene itself
# held so that the id stays its own: a render makes no host-to-device copy
# once its scene is packed.
_PACKED = {}


def _packed(scene: Whitted5Scene):
    hit = _PACKED.get(id(scene))
    if hit is None or hit[0] is not scene:
        if len(_PACKED) >= 8:
            _PACKED.pop(next(iter(_PACKED)))
        aux, uvs = pack_whitted5_aux(scene)
        atlas, textab = pack_texel_atlas(scene.textures, scene.device)
        hit = _PACKED[id(scene)] = (scene, pack_whitted5_scene(scene), aux, uvs, atlas, textab)
    return hit[1:]


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
    smem = 4 * (32 * n + 3 * len(scene.textures))
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{n} primitives need {smem} B of shared memory (> {_MAX_SMEM_BYTES})")
    table, aux, uvs, atlas, textab = _packed(scene)
    o, d = o.contiguous(), d.contiguous()
    key, ctr = (s.to(torch.uint32).contiguous() for s in state)
    nsamp = samples_per_level(trace_depth, area_samples_by_level)
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev) if return_primary_idx else None
    err = kernel_lib().whitted5_trace_cuda(
        table.data_ptr(), uvs.data_ptr(), aux.data_ptr(), n, atlas.data_ptr(),
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
