"""K3: the Whitted reflect/refract tree tracer as a hand-written CUDA kernel
(``csrc/whitted_kernel.cu``), twin of se195_raytracer_tpu/kernels/
whitted_kernel.py.

Three entries, as in the JAX package:
``whitted_trace_cuda`` traces explicit ray tiles [6, Rp/128, 128] into
acc [3, Rp/128, 128] (twin of ``whitted_trace_pallas_padded``),
``whitted_frame_cuda`` makes the camera rays in the kernel, from a camera
row passed by value as a launch parameter, and returns the finished
[H, W, 3] frame in 0..255 (twin of ``whitted_frame_pallas``),
one thread per subsample ray, each block summing the subsamples of its
``pixels_per_block`` pixels in the order of ``reduce_subsamples``, and
``whitted_taps_cuda`` emits a debug tap of the primary rays in place of
the tree (twin of ``whitted_trace_pallas_padded(debug_tap=...)``), on a
persistent grid that loads the scene once a block and takes the rays from
a counter, its light and occluder lists made here once per scene
(``tap_lists``).
Tensors on the CPU take the plain version, ``models/whitted.py``
(``whitted_trace``, ``render_whitted_scene`` and ``whitted_taps``), which
is also what the tests and ``chip_smoke.py`` hold the kernel against. Each
wrapper counts its launches in ``.launches`` and refuses inputs that
require grad (``kernels/_guard.py``).

Scene table (``pack_whitted_scene``): rows [0 type | 1-3 plane normal |
4 plane depth | 5-7 center | 8 sq_radius | 9 r_radius | 10-12 color |
13 refl | 14 diff | 15 spec | 16 refr | 17 refr_index], one column per
primitive; the light flags go beside it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.types import derived, resolve_device
from se195_raytracer_tpu_torch.kernels._guard import refuse_grad
from se195_raytracer_tpu_torch.models.whitted import (
    TAPS,
    reduce_subsamples,
    render_whitted_scene,
    whitted_camera_row,
    whitted_taps,
    whitted_trace,
    window_steps,
)
from se195_raytracer_tpu_torch.scenes.whitted_scenes import FIELDS, WhittedScene
from se195_raytracer_tpu_torch.utils.profiling import span

LANES = 128
# Rays of the explicit entry are padded to whole 8 x 128 tiles, as the JAX
# package pads them.
TILE = 8 * LANES
# Deepest tree the kernel's per-thread stack holds.
MAX_TRACE_DEPTH = 8
# Threads per block of both entries (kThreads).
THREADS = 256
# Both entries opt in past the default 48 KB of shared memory, up to the
# 227 KB a block may hold on sm_90 (~2,490 primitives at 3x3). A larger
# scene would need a sweep from global memory, which K3 does not have.
_MAX_SMEM_BYTES = 227 * 1024


def pixels_per_block(supersample: int) -> int:
    """Pixels whose ss^2 subsample rays one block of the frame entry traces:
    floor(THREADS / ss^2), at least 1."""
    return max(1, THREADS // (supersample * supersample))


def shared_memory_bytes(n: int, color_floats: int = 0) -> int:
    """Dynamic shared memory of one block (the kernel's Layout): five
    16-byte records, 1 / radius, a kind word and an occluder slot per
    primitive, the list lengths, the camera row and the block's ray colors
    (the frame entry's ``color_floats`` is ``3 * pixels_per_block(ss) *
    ss^2``, the explicit-ray entry's 0). Raises ValueError, naming the
    primitive count, above what a block can hold."""
    smem = 92 * n + 8 + 48 + 4 * color_floats
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{n} primitives need {smem} B of shared memory (> {_MAX_SMEM_BYTES})")
    return smem


def pack_whitted_scene(scene: WhittedScene) -> torch.Tensor:
    """[18, N] float32 primitive table (bitwise the JAX package's)."""
    tarr = torch.tensor(scene.ptype, dtype=torch.float32, device=scene.device)[None, :]
    return torch.cat(
        [
            tarr,
            scene.normal.T,
            scene.depth[None, :],
            scene.center.T,
            scene.sq_radius[None, :],
            scene.r_radius[None, :],
            scene.color.T,
            scene.refl[None, :],
            scene.diff[None, :],
            scene.spec[None, :],
            scene.refr[None, :],
            scene.refr_index[None, :],
        ],
        dim=0,
    ).contiguous()


def tap_lists(ptype, is_light) -> Tuple[list, int, int]:
    """(lists, nl, no): the light indices, then the occluders (the
    non-light primitives, spheres then planes, each by index), the order in
    which the kernel's ``load_scene`` lists them for K3; the tap kernel
    takes them from here."""
    lights = [j for j, lit in enumerate(is_light) if lit]
    spheres = [j for j, lit in enumerate(is_light) if not lit and ptype[j] != 0]
    planes = [j for j, lit in enumerate(is_light) if not lit and ptype[j] == 0]
    return lights + spheres + planes, len(lights), len(spheres) + len(planes)


def _packed(scene: WhittedScene):
    """(table, light flags, the taps' lists as a tensor, nl, no) on the
    scene's device, made once per scene and kept
    (``derived``: its tensors by identity and version, its static
    structure): the copies to the device would otherwise stall each
    launch. In span ``wh.tables``, with ``wh.tables.build`` inside it on a
    build; ``.lookups`` and ``.builds`` count both."""

    def build():
        with span("wh.tables.build"):
            _packed.builds += 1
            light = torch.tensor(scene.is_light, dtype=torch.int32, device=scene.device)
            lists, nl, no = tap_lists(scene.ptype, scene.is_light)
            lists = torch.tensor(lists or [0], dtype=torch.int32, device=scene.device)
            return pack_whitted_scene(scene), light, lists, nl, no

    with span("wh.tables"):
        _packed.lookups += 1
        return derived("k3.tables", tuple(getattr(scene, f) for f in FIELDS),
                       (scene.ptype, scene.is_light), build)


_packed.lookups = 0
_packed.builds = 0

# The reference's fixed viewpoint, K3's row when a frame gets none.
_FIXED_ROW = torch.from_numpy(whitted_camera_row())


def host_camera_row(cam_row) -> torch.Tensor:
    """The row K3's frame entry takes: ``cam_row`` ([12], a tensor, numpy
    array or sequence; None = the reference's fixed viewpoint) as a
    contiguous float32 CPU tensor. A CUDA tensor is read back, which syncs
    with its stream."""
    if cam_row is None:
        return _FIXED_ROW
    return torch.as_tensor(cam_row, dtype=torch.float32).reshape(12).cpu().contiguous()


_TAP_WORK: Dict[Tuple[int, int], torch.Tensor] = {}


def _tap_work(device: torch.device, stream: int) -> torch.Tensor:
    """The tap kernel's two work words (its ray counter and its count of
    finished blocks) for ``stream``: made 0 once, and each launch leaves
    them 0; launches on one stream run in order, so they share them."""
    key = (device.index, stream)
    work = _TAP_WORK.get(key)
    if work is None:
        if len(_TAP_WORK) >= 16:
            _TAP_WORK.pop(next(iter(_TAP_WORK)))
        work = _TAP_WORK[key] = torch.zeros((2,), dtype=torch.int32, device=device)
    return work


def _scene_args(scene: WhittedScene, trace_depth: int, hit_bias: float, color_floats: int):
    if not 0 <= trace_depth <= MAX_TRACE_DEPTH:
        raise ValueError(f"trace_depth {trace_depth} outside 0..{MAX_TRACE_DEPTH}")
    n = scene.num_prims
    shared_memory_bytes(n, color_floats)
    table, light = _packed(scene)[:2]
    return (table.data_ptr(), light.data_ptr(), n, float(np.float32(hit_bias)), int(trace_depth))


def _check_tiles(scene: WhittedScene, rays: torch.Tensor) -> None:
    """Raise ValueError unless ``rays`` are float32 [6, rows, 128] tiles on
    the scene's device, on the CPU or a CUDA device."""
    if rays.dim() != 3 or rays.shape[0] != 6 or rays.shape[2] != LANES:
        raise ValueError(f"rays: need [6, rows, {LANES}], got {tuple(rays.shape)}")
    if rays.device != scene.device or rays.dtype != torch.float32:
        raise ValueError(f"rays: need float32 on {scene.device}, got {rays.dtype} on {rays.device}")
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")


def whitted_trace_cuda(
    scene: WhittedScene,
    rays: torch.Tensor,
    *,
    trace_depth: int = 5,
    hit_bias: float = 0.0,
) -> torch.Tensor:
    """Trace explicit rays [6, Rp/128, 128] (origin, direction planes) on
    the scene's device; returns acc [3, Rp/128, 128], each ray's summed tree
    color before the tone scale. CPU tensors take ``whitted_trace``."""
    refuse_grad("whitted_trace_cuda", scene, rays)
    _check_tiles(scene, rays)
    rp = rays.shape[1] * LANES
    if rays.device.type == "cpu":
        flat = rays.reshape(6, rp)
        acc = whitted_trace(scene, flat[0:3].T, flat[3:6].T, trace_depth, hit_bias)
        return acc.T.reshape(3, rays.shape[1], LANES)
    rays = rays.contiguous()
    args = _scene_args(scene, trace_depth, hit_bias, 0)
    acc = torch.empty((3, rays.shape[1], LANES), dtype=torch.float32, device=rays.device)
    lib = _kernel_lib()
    err = lib.whitted_trace_cuda(*args, rays.data_ptr(), acc.data_ptr(), rp,
                                 torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whitted_trace_cuda launch failed: cudaError {err}")
    whitted_trace_cuda.launches += 1
    return acc


whitted_trace_cuda.launches = 0


def whitted_taps_cuda(
    scene: WhittedScene,
    rays: torch.Tensor,
    *,
    tap: str,
    hit_bias: float = 0.0,
) -> torch.Tensor:
    """Debug tap ``tap`` ("tres", "attr" or "shade"; ``models/whitted.
    whitted_taps`` says what each holds) of explicit rays [6, Rp/128, 128]
    on the scene's device; returns [3, Rp/128, 128]. An unknown tap raises
    ValueError. CPU tensors take ``whitted_taps``."""
    refuse_grad("whitted_taps_cuda", scene, rays)
    if tap not in TAPS:
        raise ValueError(f"unknown debug tap {tap!r}; one of {TAPS}")
    _check_tiles(scene, rays)
    rp = rays.shape[1] * LANES
    if rays.device.type == "cpu":
        flat = rays.reshape(6, rp)
        out = whitted_taps(scene, flat[0:3].T, flat[3:6].T, tap, hit_bias)
        return out.T.reshape(3, rays.shape[1], LANES)
    rays = rays.contiguous()
    args = _scene_args(scene, 0, hit_bias, 0)[:4]
    lists, nl, no = _packed(scene)[2:]
    out = torch.empty((3, rays.shape[1], LANES), dtype=torch.float32, device=rays.device)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = lib.whitted_taps_cuda(*args, lists.data_ptr(), nl, no, TAPS.index(tap),
                                rays.data_ptr(), out.data_ptr(), rp,
                                _tap_work(rays.device, stream).data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"whitted_taps_cuda launch failed: cudaError {err}")
    whitted_taps_cuda.launches += 1
    return out


whitted_taps_cuda.launches = 0


def whitted_frame_cuda(
    scene: WhittedScene,
    cam_row: Optional[torch.Tensor] = None,
    *,
    width: int,
    height: int,
    supersample: int = 3,
    trace_depth: int = 5,
    hit_bias: float = 0.0,
) -> torch.Tensor:
    """Full frame on the scene's device: camera rays made in the kernel from
    the ray index and ``cam_row`` ([12], ``whitted_camera_row``; None = the
    reference's fixed camera), the subsamples reduced and tone-scaled there.
    Returns [H, W, 3] float32 in 0..255. CPU tensors take
    ``render_whitted_scene``. The launch (the plain render on the CPU) is
    span ``wh.launch``.

    The row is taken on the host (``host_camera_row``) and passed to K3 by
    value as a launch parameter, so nothing is copied to the device before
    the launch and the call does not wait for the stream; a CUDA tensor
    given as ``cam_row`` is read back first, which does."""
    refuse_grad("whitted_frame_cuda", scene, cam_row)
    dev = scene.device
    cam_row = host_camera_row(cam_row)
    if dev.type == "cpu":
        with span("wh.launch"):
            return render_whitted_scene(scene, width, height, supersample, trace_depth,
                                        hit_bias, cam_row=cam_row)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ss2 = supersample * supersample
    args = _scene_args(scene, trace_depth, hit_bias, 3 * pixels_per_block(supersample) * ss2)
    frame = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with span("wh.launch"):
        err = lib.whitted_frame_cuda(
            *args, cam_row.data_ptr(), width, height, supersample,
            *window_steps(width, height), float(np.float32(256.0 / ss2)),
            frame.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"whitted_frame_cuda launch failed: cudaError {err}")
    whitted_frame_cuda.launches += 1
    return frame


whitted_frame_cuda.launches = 0


def render_whitted_cuda(
    scene: WhittedScene,
    width: int = 800,
    height: int = 600,
    supersample: int = 3,
    trace_depth: int = 5,
    hit_bias: float = 0.0,
    cam_row: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Full-frame Whitted render through K3 -> [H, W, 3] float32 in 0..255
    (twin of ``render_whitted_pallas``). ``device=None`` means CUDA and
    raises when no GPU is present; on the CPU the plain version runs."""
    scene = scene.to(resolve_device(device))
    return whitted_frame_cuda(scene, cam_row, width=width, height=height,
                              supersample=supersample, trace_depth=trace_depth,
                              hit_bias=hit_bias)


def rays_to_tiles(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[R, 3] origins and directions -> [6, Rp/128, 128] ray tiles, padded
    with inert rays (o = d = 0, which hit nothing) to whole ``TILE``s, the
    layout of the explicit-ray entry."""
    r = o.shape[0]
    rp = (r + TILE - 1) // TILE * TILE
    rays = torch.zeros((6, rp), dtype=torch.float32, device=o.device)
    rays[0:3, :r] = o.T
    rays[3:6, :r] = d.T
    return rays.reshape(6, rp // LANES, LANES)


def tiles_to_frame(acc: torch.Tensor, width: int, height: int, supersample: int) -> torch.Tensor:
    """acc [3, Rp/128, 128] of the camera rays -> [H, W, 3] frame in 0..255."""
    r = width * height * supersample * supersample
    return reduce_subsamples(acc.reshape(3, -1)[:, :r].T, width, height, supersample)


def _kernel_lib() -> ctypes.CDLL:
    from se195_raytracer_tpu_torch.kernels._build import load

    lib = load("whitted_kernel")
    if lib.whitted_trace_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.whitted_trace_cuda.argtypes = [p, p, i, f, i, p, p, i, p]
        lib.whitted_frame_cuda.argtypes = [p, p, i, f, i, p, i, i, i, f, f, f, f, f, p, p]
        lib.whitted_taps_cuda.argtypes = [p, p, i, f, p, i, i, i, p, p, i, p, p]
        for fn in (lib.whitted_trace_cuda, lib.whitted_frame_cuda, lib.whitted_taps_cuda):
            fn.restype = ctypes.c_int
    return lib
