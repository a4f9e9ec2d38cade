"""K1b: the backward of the hard-estimator render for small scenes, as a
hand-written CUDA kernel and its plain PyTorch version.

The JAX package differentiates its Pallas forward (K1) with ``jax.vjp`` of
its jnp path (se195_raytracer_tpu/driver/optimize.py ``_render_jnp_diff``),
one XLA program that the compiler fuses; there is no Pallas backward.
``pt_backward_cuda`` computes the same vector-Jacobian product in one launch
of ``csrc/pt_backward_kernel.cu`` (and a fixed-order sum of its blocks'
partials): per lane it replays the plain path's passes from the same seeds,
bit for bit, and sweeps each pass's bounces in reverse.
``pt_backward_reference`` is the plain version: autograd of the plain path
(``driver.optimize._render_plain_basis``) for the same cotangent, in the same
flat layout. The CPU tests and ``chip_smoke.py`` hold the kernel to it.

The gradient is flat, [10 N + 12] float32 (``pack_grad`` / ``unpack_grad``):
the spheres' center [N, 3], radius [N], emission [N, 3] and color [N, 3],
then the camera basis orig, dir, x and y (``update_camera``'s output). The
camera's own leaves get theirs through ``update_camera`` on the host
(``driver.optimize._KernelForward``).

The kernel sums each bounce's hit-sphere row (centre, radius, colour) by one
of two routes, which its C entry point takes from the scene's shape
(``k1b_lane_columns`` mirrors the choice, ``k1b_shared_memory_bytes`` the
bytes): per-lane columns in shared memory, each thread adding into its own
and the block folding them at its end, wherever a block with them still fits
four to an SM (on sm_90 up to 14 spheres: every K1 scene of the zoo); else
warp rounds, one shuffle reduction per distinct sphere id among a warp's
lanes. ``pt_backward_cuda.lane_column_launches`` counts the launches that
took the columns.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.types import CameraBasis, Scene
from se195_raytracer_tpu_torch.kernels._guard import refuse_grad
from se195_raytracer_tpu_torch.kernels.pt_kernel import (device_copy, light_list, pixel_range,
                                                         scene_table, uses_k2)
from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes

# The bounces a lane's record holds (kMaxDepth in csrc/pt_backward_kernel.cu).
MAX_DEPTH = 16
SCENE_FIELDS = ("center", "radius", "emission", "color")
# K1b against its plain version (the plain path's VJP of the same
# cotangent), ``grad_row_error``: each sphere's row within GRAD_ROW_REL of
# its own largest plain gradient, floored at GRAD_ROW_FLOOR of the field's.
# On an H100 at Cornell 512^2 spp 2 the kernel read at most 2.8e-5 (PT and
# DL, mwc and counter, four cotangents), and the weakest of the faults that
# tools/k1b_fault_check.py plants (the light sample's wi term cut from the
# normal) at least 3.2e-3 on every cotangent; the bar sits between them.
GRAD_ROW_REL = 3e-4
GRAD_ROW_FLOOR = 1e-3
BASIS_FIELDS = ("orig", "dir", "x", "y")
# K1b's launch (csrc/pt_backward_kernel.cu): threads a block, warps a block,
# blocks an SM it must keep, rows of the scene table.
THREADS = 128
WARPS = THREADS // 32
MIN_BLOCKS = 4
SCENE_ROWS = 12
# sm_90's shared memory an SM, the runtime's reservation a block and the
# opt-in limit a block, as cudaDeviceGetAttribute reads them on an H100.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
SMEM_PER_BLOCK_OPTIN = 227 * 1024


def grad_size(n: int) -> int:
    """Entries of the flat gradient of an ``n``-sphere scene."""
    return 10 * n + 12


def pack_grad(center, radius, emission, color, orig, dir, x, y) -> torch.Tensor:
    """The flat [10 N + 12] gradient: center [N, 3], radius [N], emission
    [N, 3], color [N, 3], then the basis vectors orig, dir, x, y ([3] each)."""
    return torch.cat([t.reshape(-1) for t in (center, radius, emission, color, orig, dir, x, y)])


def unpack_grad(flat: torch.Tensor, n: int) -> Dict[str, torch.Tensor]:
    """``pack_grad``'s inverse: views of ``flat`` by field name (the scene's
    ``SCENE_FIELDS`` and the basis's ``BASIS_FIELDS``)."""
    sizes = (3 * n, n, 3 * n, 3 * n, 3, 3, 3, 3)
    shapes = ((n, 3), (n,), (n, 3), (n, 3), (3,), (3,), (3,), (3,))
    parts = torch.split(flat, sizes)
    return {k: p.reshape(s) for k, p, s in zip(SCENE_FIELDS + BASIS_FIELDS, parts, shapes)}


def grad_row_error(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """Per field, the worst row of ``got`` against ``want``: max |got -
    want| over a row divided by the row's largest |want|, floored at
    ``GRAD_ROW_FLOOR`` of the field's largest. A row of a scene field
    (``SCENE_FIELDS``) is one sphere's entries; any other field (a basis
    vector, a camera leaf) is one row. So a fault confined to one sphere
    (the glass sphere's Fresnel term, say) is measured against that
    sphere's own gradient, not hidden under the walls'."""
    out = {}
    for k, b in want.items():
        n = b.shape[0] if k in SCENE_FIELDS else 1
        a, b = got[k].reshape(n, -1), b.reshape(n, -1)
        scale = b.abs().amax(dim=1).clamp(min=GRAD_ROW_FLOOR * float(b.abs().max()))
        err = (a - b).abs().amax(dim=1) / torch.where(scale > 0, scale, torch.ones_like(scale))
        out[k] = float(err.max())
    return out


def running_mean_weights(spp: int) -> List[float]:
    """d accum / d r_k of the plain path's running mean ``accum = (accum * k
    + r_k) / (k + 1)`` over ``spp`` passes, in float32, in the order autograd
    takes them for a cotangent of 1: the last pass's weight is 1 / spp, and
    the cotangent passed back is the weight times k. The kernel scales each
    lane's cotangent by these."""
    out = []
    g = np.float32(1.0)
    for k in range(spp - 1, -1, -1):
        w = g / np.float32(k + 1)
        out.append(float(w))
        g = w * np.float32(k)
    return out[::-1]


def running_mean_weights_tensor(spp: int, device) -> torch.Tensor:
    """``running_mean_weights(spp)`` as a float32 tensor on ``device``, kept
    by ``device_copy``: a backward on the card copies nothing from the host
    for them. Callers must not write to it."""
    return device_copy(running_mean_weights(spp), torch.float32, device)


def k1b_shared_memory_bytes(n: int, n_lights: int, lane_columns: bool) -> int:
    """Bytes of shared memory a K1b block holds for ``n`` spheres and
    ``n_lights`` lights (``smem_bytes`` in csrc/pt_backward_kernel.cu counts
    the same): a (center, radius) float4 per sphere, the scene's rows, the
    camera row, each warp's gradient table, with ``lane_columns`` a column of
    7 n floats per thread, and the light list."""
    floats = (SCENE_ROWS * n + 12 + WARPS * grad_size(n)
              + (7 * n * THREADS if lane_columns else 0))
    return 16 * n + 4 * floats + 4 * n_lights


def k1b_lane_columns(n: int, n_lights: int, smem_per_sm: int = SMEM_PER_SM,
                     reserved: int = SMEM_RESERVED_PER_BLOCK,
                     optin: int = SMEM_PER_BLOCK_OPTIN) -> bool:
    """Whether K1b takes the per-lane columns for ``n`` spheres and
    ``n_lights`` lights, as its C entry point decides from the device's
    limits (sm_90's by default): a block that holds them within the opt-in
    limit, and ``MIN_BLOCKS`` of them, each with the runtime's reservation,
    within an SM's shared memory. Else the warp rounds."""
    b = k1b_shared_memory_bytes(n, n_lights, True)
    return b <= optin and MIN_BLOCKS * (b + reserved) <= smem_per_sm


def pt_backward_reference(scene: Scene, basis: CameraBasis, config: RenderConfig,
                          grad_out: torch.Tensor, pixels: Optional[Tuple[int, int]] = None,
                          image: bool = False):
    """The plain version of K1b on any device: autograd of
    ``_render_plain_basis`` (the plain path from the camera basis on, with
    the same seeds) for the cotangent ``grad_out`` ([H, W, 3], or [hi - lo,
    3] with ``pixels=(lo, hi)``), in ``pack_grad``'s layout. With ``image``
    also returns the primal ([hi - lo, 3] rows)."""
    from se195_raytracer_tpu_torch.driver.optimize import _render_plain_basis

    lo, hi = pixel_range(config, pixels)
    leaves = [t.detach().requires_grad_(True) for t in
              (scene.center, scene.radius, scene.emission, scene.color,
               basis.orig, basis.dir, basis.x, basis.y)]
    with torch.enable_grad():
        sc = Scene(*leaves[:4], scene.refl, scene.light_indices)
        img = _render_plain_basis(sc, CameraBasis(*leaves[4:]), config, pixels=pixels)
        g = torch.autograd.grad(img, leaves, grad_out.reshape(img.shape), allow_unused=True)
    g = [torch.zeros_like(t) if x is None else x for t, x in zip(leaves, g)]
    flat = pack_grad(*g)
    if image:
        return flat, img.detach().reshape(hi - lo, 3)
    return flat


def k1b_takes(device, num_spheres: int, max_depth: int, soft_edges: float) -> bool:
    """Whether K1b takes the backward of a render on ``device`` of
    ``num_spheres`` spheres, ``max_depth`` bounces and ``soft_edges``: a
    CUDA device, K1's scenes (``uses_k2`` false: K1b has no blocked sweep),
    the bounces its record holds and the hard estimator.
    ``pt_backward_cuda`` refuses the rest, for which
    ``driver.optimize._KernelForward`` recomputes the plain path."""
    return (torch.device(device).type == "cuda" and not uses_k2(num_spheres)
            and 1 <= max_depth <= MAX_DEPTH and soft_edges == 0.0)


def pt_backward_cuda(scene: Scene, basis: CameraBasis, config: RenderConfig,
                     grad_out: torch.Tensor, pixels: Optional[Tuple[int, int]] = None,
                     image: bool = False):
    """K1b: the gradient of ``sum(grad_out * _render_plain_diff(...))`` with
    respect to the scene's center, radius, emission and color and the
    camera basis, flat in ``pack_grad``'s layout, where ``k1b_takes``.
    ``grad_out`` is [H, W, 3], or [hi - lo, 3] with ``pixels=(lo, hi)``
    (the rows of a shard).

    Seeds the lanes once (``seed_lanes``, the plain path's layout: lane i
    is pixel lo + i) and launches the kernel on the current stream (its
    reduction in the same call), on ``scene_table``'s table (the
    forward's, for an unchanged scene). What ``k1b_takes`` refuses raises,
    as does a refused launch. ``image`` also returns the kernel's replayed
    primal, [hi - lo, 3], the plain path's image bit for bit. Counts its
    calls in ``pt_backward_cuda.launches``, and those that took the
    per-lane columns in ``pt_backward_cuda.lane_column_launches``."""
    refuse_grad("pt_backward_cuda", scene, basis, grad_out)
    dev = scene.center.device
    n = scene.num_spheres
    if not k1b_takes(dev, n, config.max_depth, config.soft_edges):
        raise ValueError(
            f"pt_backward_cuda: CUDA tensors only, K1's scenes, max_depth 1..{MAX_DEPTH} and the "
            f"hard estimator; got {n} spheres on {dev}, max_depth {config.max_depth}, soft_edges "
            f"{config.soft_edges}. Elsewhere take pt_backward_reference")
    lo, hi = pixel_range(config, pixels)
    lanes = hi - lo
    tab = scene_table(scene)
    cam = torch.cat([basis.orig, basis.dir, basis.x, basis.y]).contiguous()
    if grad_out.numel() != 3 * lanes:
        raise ValueError(f"grad_out: need {lanes} x 3 values, got {tuple(grad_out.shape)}")
    g = grad_out.reshape(lanes, 3).contiguous()
    for name, t in (("scene", tab), ("basis", cam), ("grad_out", g)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
    lights = light_list(scene.light_indices, dev)
    weights = running_mean_weights_tensor(config.spp, dev)
    lib = _lib()
    partials = torch.empty((lib.pt_backward_blocks(lo, hi), grad_size(n)), dtype=torch.float32,
                           device=dev)
    out = torch.empty((grad_size(n),), dtype=torch.float32, device=dev)
    img = torch.empty((lanes, 3), dtype=torch.float32, device=dev) if image else None
    s0, s1 = seed_lanes(config.rng, config.seed, config.width * config.height, lanes,
                        lane_offset=lo, device=dev)
    cols = ctypes.c_int(0)
    err = lib.pt_backward_cuda(
        tab.data_ptr(), n, lights.data_ptr(), len(scene.light_indices), cam.data_ptr(),
        s0.data_ptr(), s1.data_ptr(), g.data_ptr(), weights.data_ptr(), config.spp, lo, hi,
        config.width, config.height, float(np.float32(1.0 / config.width)),
        float(np.float32(1.0 / config.height)), config.max_depth,
        int(config.integrator == "dl"), int(config.rng == "counter"), partials.data_ptr(),
        out.data_ptr(), None if img is None else img.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(cols))
    if err != 0:
        raise RuntimeError(f"pt_backward_cuda launch failed: cudaError {err}")
    pt_backward_cuda.launches += 1
    pt_backward_cuda.lane_column_launches += cols.value
    return (out, img) if image else out


pt_backward_cuda.launches = 0
pt_backward_cuda.lane_column_launches = 0


def route(n: int, n_lights: int) -> Dict[str, int]:
    """K1b's route on the current card for ``n`` spheres and ``n_lights``
    lights, as its C entry point takes it: ``lane_columns`` (1 or 0), the
    ``shared_bytes`` a block of that route holds, and the three limits the
    choice read (``smem_per_sm``, ``reserved``, ``optin``). Needs a GPU."""
    out = (ctypes.c_int * 5)()
    err = _lib().pt_backward_route(n, n_lights, out)
    if err != 0:
        raise RuntimeError(f"pt_backward_route failed: CUDA error {err}")
    return dict(zip(("lane_columns", "shared_bytes", "smem_per_sm", "reserved", "optin"), out))


def occupancy(scene: Scene, config: RenderConfig) -> Dict[str, int]:
    """K1b's build for ``config``'s integrator and RNG and ``scene``'s route
    on the current card: its warps resident on one SM for ``scene`` (the CUDA
    occupancy calculator, from the build's registers and the launch's shared
    memory), its registers and its local memory (the stack frame) a thread,
    as ``cudaFuncGetAttributes`` reads them, the route (``lane_columns``) and
    the shared memory a block holds. Needs a GPU."""
    out = (ctypes.c_int * 5)()
    err = _lib().pt_backward_occupancy(scene.num_spheres, len(scene.light_indices),
                                       int(config.integrator == "dl"),
                                       int(config.rng == "counter"), out)
    if err != 0:
        raise RuntimeError(f"pt_backward_occupancy failed: CUDA error {err}")
    return {"resident_warps_per_sm": out[0], "registers": out[1], "local_bytes": out[2],
            "lane_columns": out[3], "shared_bytes": out[4]}


def _lib() -> ctypes.CDLL:
    from se195_raytracer_tpu_torch.kernels._build import load

    lib = load("pt_backward_kernel")
    if lib.pt_backward_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pt_backward_cuda.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i, i, i, f, f, i, i,
                                         i, p, p, p, p, ctypes.POINTER(i)]
        lib.pt_backward_cuda.restype = ctypes.c_int
        lib.pt_backward_blocks.argtypes = [i, i]
        lib.pt_backward_blocks.restype = ctypes.c_int
        lib.pt_backward_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.pt_backward_occupancy.restype = ctypes.c_int
        lib.pt_backward_route.argtypes = [i, i, ctypes.POINTER(i)]
        lib.pt_backward_route.restype = ctypes.c_int
    return lib
