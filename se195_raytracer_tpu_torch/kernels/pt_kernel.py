"""K1 and K2: the fused path-tracing pass, as hand-written CUDA kernels and
their plain PyTorch version (twin of se195_raytracer_tpu/kernels/pt_kernel.py).

``pt_multi_pass`` runs ``num_samples`` progressive passes in one launch of
``csrc/pt_kernel.cu``: K1 for scenes of at most ``UNROLL_MAX_SPHERES``
spheres, K2 (``pt_blocked_pass``, a sweep in blocks of ``SPHERE_BLOCK``
spheres that skips, per ray, the remainder, groups, blocks and half blocks
whose bounds the ray cannot meet or enters beyond its best hit) above. K2
runs from the same source built with its sphere test and path geometry
rounded as the plain version rounds them (``csrc/pt_blocked_kernel.cu``),
K1 from the source's own build.
``pt_pass_reference`` computes the same passes with ``generate_camera_rays``
+ ``radiance`` over the same lanes and state, and is what the wrappers run
for tensors on the CPU (and what the tests and ``chip_smoke.py`` hold the
kernels against).
``render_cuda`` is the twin of ``render_pallas``: its state ``(s0 [Rp],
s1 [Rp], acc [3, Rp/128, 128], sample)`` has the JAX package's layout, lane
order and pad-lane seeding, so a state can be carried across between the
two packages (``convert.py``).

Every wrapper refuses inputs that require grad (``kernels/_guard.py``):
a kernel's output has no autograd history;
``driver/optimize.render_differentiable`` pairs K1/K2's forward with a
backward of its own (K1b, ``kernels/pt_backward_kernel.py``, for K1's
scenes on the card; the plain path's autograd otherwise).

Scene table layout (``pack_scene``): rows are
[cx, cy, cz, rad, ex, ey, ez, colr, colg, colb, refl, emissive], one column
per sphere.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.rng import init_state
from se195_raytracer_tpu_torch.core.types import (
    Camera,
    CameraBasis,
    Scene,
    derived,
    device_copy,
    dot3,
    resolve_device,
    sqrt_rn,
    update_camera,
)
from se195_raytracer_tpu_torch.kernels._guard import refuse_grad
from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes
from se195_raytracer_tpu_torch.models.smallpt import generate_camera_rays, radiance
from se195_raytracer_tpu_torch.ops.intersect import sphere_intersect
from se195_raytracer_tpu_torch.utils.profiling import span

LANES = 128
# Lanes are padded to whole 16 x 128 tiles, as in the JAX package, so the
# two packages' states have the same shape.
SUBLANES = 16
TILE = SUBLANES * LANES
# Above this many spheres the pass runs in K2, the blocked sweep.
UNROLL_MAX_SPHERES = 96
# Spheres per block of K2's sweep; one bounding sphere per block.
SPHERE_BLOCK = 16
# Blocks per group of K2's sweep; one bounding sphere per group.
GROUP_BLOCKS = 4
# K2's cull widens a bound's radius R' by CULL_REACH * (|b| + 2 R'), b the
# distance along the ray to the bound's center, so that the rounding of a
# sphere's t and of the bound's entry, which grows with the distance, can
# never skip a hit (kReach in csrc/pt_kernel.cu, which argues it).
CULL_REACH = 2e-3
# The kernels keep the scene in shared memory; K2 opts in past the default
# 48 KB, up to the 227 KB a block may hold on sm_90. A larger scene would
# need a sweep from global memory, which no kernel has.
_MAX_SMEM_BYTES = 227 * 1024

PTState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]


def uses_k2(num_spheres: int) -> bool:
    """Whether a scene of ``num_spheres`` spheres renders in K2 and its
    blocked lane layout, or in K1 and the identity layout: every route
    through the two kernels asks this."""
    return num_spheres > UNROLL_MAX_SPHERES


def pack_scene(scene: Scene) -> torch.Tensor:
    """[12, N] float32 scene table. Row 11 is the emissive flag: the
    reference's viszero test (vec.h:44, y-bug included), baked host-side
    from ``light_indices``."""
    emissive = torch.zeros((1, scene.num_spheres), dtype=torch.float32,
                           device=scene.device).index_fill_(
        1, device_copy(scene.light_indices, torch.int64, scene.device), 1.0)
    return torch.cat(
        [
            scene.center.T,
            scene.radius[None, :],
            scene.emission.T,
            scene.color.T,
            scene.refl.to(torch.float32)[None, :],
            emissive,
        ],
        dim=0,
    ).contiguous()


def scene_table(scene: Scene) -> torch.Tensor:
    """``pack_scene(scene)``, kept per scene (``derived``), so that a render
    of an unchanged scene packs nothing and finds K2's tables built."""
    return derived("scene_table", (scene.center, scene.radius, scene.emission, scene.color,
                                   scene.refl), (scene.light_indices,), lambda: pack_scene(scene))


def pack_camera(basis: CameraBasis) -> torch.Tensor:
    """[1, 12] float32: orig, dir, x, y."""
    return torch.cat([basis.orig, basis.dir, basis.x, basis.y]).reshape(1, 12)


def _bounding_spheres(scene_tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[4, k] inflated bounding spheres of the sphere index sets idx [k, s]."""
    c3 = scene_tab[0:3][:, idx]
    rad = scene_tab[3][idx]
    lo = (c3 - rad[None]).amin(dim=-1)
    hi = (c3 + rad[None]).amax(dim=-1)
    bc = 0.5 * (lo + hi)  # [3, nb]
    dc = c3 - bc[:, :, None]
    dist = sqrt_rn(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
    br = (dist + rad).amax(dim=-1)
    br = br * float(np.float32(1.001)) + float(np.float32(0.01))
    return torch.cat([bc, br[None]], dim=0).contiguous()


def block_bounds(scene_tab: torch.Tensor) -> torch.Tensor:
    """[4, nb] (cx, cy, cz, rad) bounding spheres of the contiguous
    ``SPHERE_BLOCK``-sized index ranges of the scene table (the fractal
    generator emits spheres depth first, so a range is a tight subtree).
    The radius is inflated, x1.001 + 0.01, so that rounding in the bound
    test can never reject a block that holds a true hit: the culled sweep
    gives the same bits as the full one. Bitwise equal to the JAX
    package's ``block_bounds``."""
    nb = scene_tab.shape[1] // SPHERE_BLOCK
    idx = torch.arange(nb * SPHERE_BLOCK, device=scene_tab.device).reshape(nb, SPHERE_BLOCK)
    return _bounding_spheres(scene_tab, idx)


def half_bounds(scene_tab: torch.Tensor) -> torch.Tensor:
    """[4, 2 nb] bounding spheres of the half blocks (``SPHERE_BLOCK // 2``
    spheres; half h holds spheres 8h .. 8h+7), inflated as ``block_bounds``
    inflates, so K2 can skip half a block exactly."""
    nb = scene_tab.shape[1] // SPHERE_BLOCK
    half = SPHERE_BLOCK // 2
    idx = torch.arange(nb * SPHERE_BLOCK, device=scene_tab.device).reshape(2 * nb, half)
    return _bounding_spheres(scene_tab, idx)


def group_bounds(scene_tab: torch.Tensor) -> torch.Tensor:
    """[4, ng] bounding spheres of the groups of ``GROUP_BLOCKS`` consecutive
    blocks (ng = ceil(nb / GROUP_BLOCKS); the last group may hold fewer),
    computed from the groups' spheres as ``block_bounds`` computes a block's
    and inflated the same way, so K2 can skip a group, and its blocks' bound
    tests, exactly as it skips a block."""
    nb = scene_tab.shape[1] // SPHERE_BLOCK
    m = nb * SPHERE_BLOCK
    size = GROUP_BLOCKS * SPHERE_BLOCK
    ng = (nb + GROUP_BLOCKS - 1) // GROUP_BLOCKS
    start = torch.arange(ng, device=scene_tab.device)[:, None] * size
    # A short last group repeats its last sphere, which moves no bound.
    idx = torch.clamp(start + torch.arange(size, device=scene_tab.device)[None, :], max=m - 1)
    return _bounding_spheres(scene_tab, idx)


def remainder_bound(scene_tab: torch.Tensor) -> torch.Tensor:
    """[4, 1] bounding sphere of the remainder, the spheres after the last
    whole block (a zero sphere when there is none), inflated as
    ``block_bounds`` inflates, so K2 can skip the remainder exactly."""
    n = scene_tab.shape[1]
    m = n // SPHERE_BLOCK * SPHERE_BLOCK
    if n == m:
        return torch.zeros((4, 1), dtype=scene_tab.dtype, device=scene_tab.device)
    return _bounding_spheres(scene_tab, torch.arange(m, n, device=scene_tab.device)[None, :])


def bound_entry(bounds: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                reach: float = CULL_REACH):
    """K2's bound test in plain torch, [R] rays against [4, k] bounds:
    (meets [R, k], entry [R, k]). ``meets``: the ray's line crosses the
    bounding sphere, its radius widened by ``reach`` * (|b| + 2 R), ahead of
    the origin; ``entry``: where it enters, b - sqrt(det), negative from
    inside. ``reach=0`` is the JAX package's ``block_possible``."""
    op = bounds[:3].T[None] - o[:, None, :]  # [R, k, 3]
    b = dot3(op, d[:, None, :])
    r = bounds[3] + float(np.float32(reach)) * (torch.abs(b) + 2.0 * bounds[3])
    det = b * b - dot3(op, op) + r * r
    sq = sqrt_rn(torch.clamp(det, min=0.0))
    return (det >= 0.0) & ((b + sq) > 0.0), b - sq


@functools.lru_cache(maxsize=32)
def ray_layout(width: int, height: int, blocked: bool = False, tile_multiple: int = 1):
    """Lane <-> pixel layout of the kernels' state, as the JAX package lays
    it out (``ray_layout`` there, 16 x 128 lane tiles).

    Returns (rp, pix, inv) as host numpy: ``rp`` = padded lane count,
    ``pix[lane]`` = absolute pixel id (pad lanes get ``width*height``, one
    past the end), ``inv[pixel]`` = the lane holding that pixel (None for
    the identity layout, where lane == pixel and the image is a slice).
    ``blocked`` (K2's layout) makes each 16 x 128 lane tile one 64 x 32
    image block, so neighbouring lanes trace neighbouring rays.
    ``tile_multiple`` rounds the tile count up to a multiple of it, so that
    a sharded render gives every shard the same whole tiles; the added
    tiles are pad lanes."""
    r = width * height
    m = tile_multiple

    def round_tiles(ntiles):
        return (ntiles + m - 1) // m * m

    if not blocked:
        rp = round_tiles((r + TILE - 1) // TILE) * TILE
        return rp, np.arange(rp, dtype=np.int32), None
    th_ = 32
    tw_ = TILE // th_
    gw = (width + tw_ - 1) // tw_
    gh = (height + th_ - 1) // th_
    rp = round_tiles(gw * gh) * TILE
    lanes = np.arange(rp)
    ti, wi = lanes // TILE, lanes % TILE
    wy, wx = wi // tw_, wi % tw_
    tr, tc = ti // gw, ti % gw
    px = tc * tw_ + wx
    py = tr * th_ + wy
    valid = (px < width) & (py < height) & (ti < gw * gh)
    pix = np.where(valid, py * width + px, r).astype(np.int32)
    inv = np.empty(r, np.int64)
    inv[pix[valid]] = lanes[valid]
    return rp, pix, inv


class Layout(NamedTuple):
    """``ray_layout`` on a device: ``rp`` lanes, ``pix`` int32 [rp] lane ->
    pixel and ``inv`` int64 [W*H] pixel -> lane (None for the identity)."""

    blocked: bool
    rp: int
    pix: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]

    def lanes(self, lo: int, hi: int):
        """(pix, lane_offset) of lanes lo..hi-1 for ``pt_multi_pass`` and
        ``seed_lanes``: K2's slice of the pix table, or K1's first lane."""
        return (self.pix[lo:hi], 0) if self.blocked else (None, lo)

    def seed(self, config, lo: int, hi: int, device) -> Tuple[torch.Tensor, ...]:
        """Fresh (s0, s1, acc [3, (hi - lo) / 128, 128]) of lanes lo..hi-1,
        seeded by ``seed_lanes`` from the whole frame's stream."""
        pix, offset = self.lanes(lo, hi)
        s0, s1 = seed_lanes(config.rng, config.seed, config.width * config.height, hi - lo,
                            pix=pix, lane_offset=offset, device=device)
        acc = torch.zeros((3, (hi - lo) // LANES, LANES), dtype=torch.float32, device=device)
        return s0, s1, acc

    def image(self, acc: torch.Tensor, width: int, height: int) -> torch.Tensor:
        """The [H, W, 3] image of a whole frame's acc [3, ...]."""
        flat = acc.reshape(3, -1)
        flat = flat[:, self.inv] if self.blocked else flat[:, :width * height]
        return flat.T.reshape(height, width, 3)


def lane_layout(width: int, height: int, blocked: bool, tile_multiple: int, device) -> Layout:
    """``ray_layout``'s layout, its tables copied to ``device`` once per key
    and kept (``derived``)."""
    device = torch.device(device)

    def build():
        rp, pix, inv = ray_layout(width, height, blocked, tile_multiple)
        if not blocked:
            return Layout(False, rp, None, None)
        return Layout(True, rp, torch.from_numpy(pix).to(device), torch.from_numpy(inv).to(device))

    return derived("lane_layout", (), (width, height, blocked, tile_multiple, str(device)), build)


def pt_pass_reference(
    scene_tab: torch.Tensor,
    cam_tab: torch.Tensor,
    start_sample: int,
    s0: torch.Tensor,
    s1: torch.Tensor,
    acc: torch.Tensor,
    pix: Optional[torch.Tensor] = None,
    *,
    num_samples: int,
    width: int,
    height: int,
    max_depth: int,
    direct_only: bool,
    light_indices: Tuple[int, ...],
    rng: str = "mwc",
    on_sweep: Optional[Callable] = None,
    lane_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 and K2 on the same inputs:
    ``num_samples`` passes of camera rays + ``radiance`` over all Rp lanes,
    each followed by the kernels' running mean
    ``acc = (acc * samp + rad) * (1 / (samp + 1))``. ``pix`` is the pixel id
    of each lane (None: lane_offset + lane, K1's identity layout); a pad
    lane's id ``width*height`` gives camera y = -1, as in the JAX kernel.
    ``on_sweep`` is passed to ``radiance``. Returns (s0, s1, acc)."""
    scene = Scene(
        center=scene_tab[0:3].T,
        radius=scene_tab[3],
        emission=scene_tab[4:7].T,
        color=scene_tab[7:10].T,
        refl=scene_tab[10],
        light_indices=tuple(light_indices),
    )
    cam = cam_tab.reshape(12)
    basis = CameraBasis(orig=cam[0:3], dir=cam[3:6], x=cam[6:9], y=cam[9:12])
    rp = s0.shape[0]
    if pix is None:
        pix = torch.arange(lane_offset, lane_offset + rp, dtype=torch.int64, device=s0.device)
    elif lane_offset:
        raise ValueError("lane_offset is for K1's identity layout: pass it without pix")
    pix = pix.to(torch.int64)
    xs = pix % width
    ys = (height - 1) - pix // width
    state = (s0, s1)
    for i in range(num_samples):
        o, d, state = generate_camera_rays(basis, state, width, height, xs, ys, rng)
        rad, state = radiance(scene, o, d, state, max_depth, direct_only, rng, on_sweep)
        samp = np.float32(start_sample + i)
        k2 = float(np.float32(1.0) / (samp + np.float32(1.0)))
        acc = (acc * float(samp) + rad.T.reshape(acc.shape)) * k2
    return state[0].to(torch.uint32), state[1].to(torch.uint32), acc


def culled_work_counter(scene_tab: torch.Tensor) -> Tuple[Callable, Dict[str, int]]:
    """A ``radiance`` ``on_sweep`` hook that counts the work K2's per-ray
    culled sweep must do on each sweep the plain version runs, and the dict
    it adds into: ``nearest_rays`` / ``shadow_rays`` (sweeps run),
    ``nearest_tests`` / ``shadow_tests`` (sphere tests) and ``bound_tests``.

    A nearest sweep tests every block bound and the spheres of the
    remainder and of each block whose bound the ray can hit. A shadow sweep
    stops at its first occluder in the sweep's order (remainder N-1 ..
    nb*16, then blocks nb-1 .. 0), so it counts the bounds and spheres up to
    that one. These are the JAX algorithm's per-ray culled work, K2's
    bound.

    The ``kernel_*`` keys count, per ray, what K2's own sweep tests: the
    remainder's bound and the group bounds (``kernel_group_tests``), the
    block bounds of the groups it keeps and the half-block bounds of the
    blocks it keeps (``kernel_bound_tests``), and the spheres of the
    remainder and of the half blocks it keeps (``kernel_nearest_tests`` /
    ``kernel_shadow_tests``), where a bound is kept when the ray meets it
    and enters it no farther than the best t so far (nearest) or closer
    than max_t (shadow), the bound widened by ``CULL_REACH`` as K2 widens
    it."""
    halves = half_bounds(scene_tab)
    bounds = block_bounds(scene_tab)
    groups = group_bounds(scene_tab)
    rest = remainder_bound(scene_tab)
    n = scene_tab.shape[1]
    nb = bounds.shape[1]
    ng = groups.shape[1]
    m = nb * SPHERE_BLOCK
    half = SPHERE_BLOCK // 2
    work = dict(nearest_rays=0, shadow_rays=0, nearest_tests=0, shadow_tests=0, bound_tests=0,
                kernel_group_tests=0, kernel_bound_tests=0, kernel_nearest_tests=0,
                kernel_shadow_tests=0)
    scene = Scene(center=scene_tab[0:3].T, radius=scene_tab[3], emission=scene_tab[4:7].T,
                  color=scene_tab[7:10].T, refl=scene_tab[10])
    dev = scene_tab.device
    blk = torch.arange(nb, device=dev)
    blk_group = blk // GROUP_BLOCKS
    blk_last = blk * SPHERE_BLOCK + (SPHERE_BLOCK - 1)
    half_last = torch.arange(2 * nb, device=dev) * half + (half - 1)
    # The highest block of each group: the sweep enters the group there.
    grp_top = torch.clamp((torch.arange(ng, device=dev) + 1) * GROUP_BLOCKS, max=nb) - 1
    sizes = torch.clamp(nb - torch.arange(ng, device=dev) * GROUP_BLOCKS, max=GROUP_BLOCKS)
    idx = torch.arange(n, device=dev)
    inf = float("inf")

    def hook(o, d, mask, max_t):
        o, d = o[mask], d[mask]
        rays = o.shape[0]
        hmeets, hentry = bound_entry(halves, o, d)  # [R, 2 nb]
        possible = bound_entry(bounds, o, d, reach=0.0)[0]  # [R, nb], the yardstick's
        bmeets, entry = bound_entry(bounds, o, d)  # [R, nb]
        gmeets, gentry = bound_entry(groups, o, d)  # [R, ng]
        rmeets, rentry = bound_entry(rest, o, d)  # [R, 1]
        t = sphere_intersect(scene, o, d)  # [R, n]
        work["kernel_group_tests"] += rays * (ng + 1)
        if max_t is None:
            work["nearest_rays"] += rays
            work["bound_tests"] += rays * nb
            work["nearest_tests"] += rays * (n - m) + SPHERE_BLOCK * int(possible.sum())
            # The best t before each half block: the remainder's, then the
            # halves above it (a skipped one holds no better hit, so its
            # minimum can join the running one).
            tm = torch.where(t != 0.0, t, inf)
            rem = tm[:, m:].amin(dim=1) if n > m else torch.full((rays,), inf, device=dev)
            h_min = tm[:, :m].reshape(rays, 2 * nb, half).amin(dim=2)
            above = torch.flip(torch.cummin(torch.flip(h_min, (1,)), dim=1).values, (1,))
            above = torch.cat([above[:, 1:], torch.full((rays, 1), inf, device=dev)], 1)
            best_h = torch.minimum(above, rem[:, None])  # [R, 2 nb]
            best = best_h[:, 1::2]  # before each block: before its upper half
            keep_g = gmeets & ~(gentry > best[:, grp_top])
            keep_b = keep_g[:, blk_group] & bmeets & ~(entry > best)
            keep_h = keep_b.repeat_interleave(2, dim=1) & hmeets & ~(hentry > best_h)
            work["kernel_bound_tests"] += int((keep_g.sum(dim=0) * sizes).sum()) + 2 * int(
                keep_b.sum())
            work["kernel_nearest_tests"] += (n - m) * int(rmeets.sum()) + half * int(keep_h.sum())
            return
        work["shadow_rays"] += rays
        mt = max_t[mask][:, None]
        occluder = (t != 0.0) & (t < mt)
        tested = torch.cat([possible.repeat_interleave(SPHERE_BLOCK, dim=1),
                            torch.ones((rays, n - m), dtype=torch.bool, device=dev)], dim=1)
        first = torch.where(occluder & tested, idx, -1).amax(dim=1)  # -1: no occluder
        work["shadow_tests"] += int((tested & (idx[None] >= first[:, None])).sum())
        work["bound_tests"] += int((blk_last[None] >= first[:, None]).sum())
        keep_g = gmeets & (gentry < mt)
        keep_b = keep_g[:, blk_group] & bmeets & (entry < mt)
        keep_h = keep_b.repeat_interleave(2, dim=1) & hmeets & (hentry < mt)
        keep_r = (rmeets & (rentry < mt)).expand(rays, n - m)
        tested = torch.cat([keep_h.repeat_interleave(half, dim=1), keep_r], dim=1)
        first = torch.where(occluder & tested, idx, -1).amax(dim=1)
        # No occluder came before a bound that the sweep reaches.
        reached = blk_last[None] >= first[:, None]  # [R, nb]
        reached_h = half_last[None] >= first[:, None]  # [R, 2 nb]
        work["kernel_group_tests"] -= int((~reached[:, grp_top]).sum())
        work["kernel_bound_tests"] += int((keep_g[:, blk_group] & reached).sum()) + int(
            (keep_b.repeat_interleave(2, dim=1) & reached_h).sum())
        work["kernel_shadow_tests"] += int((tested & (idx[None] >= first[:, None])).sum())

    return hook, work


def k2_shared_memory_bytes(n: int, n_lights: int) -> int:
    """Bytes of shared memory a K2 block holds for ``n`` spheres and
    ``n_lights`` lights (``launch`` in csrc/pt_kernel.cu counts the same): a
    (center, radius) record per sphere and per half block, block and group
    bound, the camera row and the light list. Raises ValueError, naming the
    sphere count, above what a block can hold."""
    nb = n // SPHERE_BLOCK
    ng = (nb + GROUP_BLOCKS - 1) // GROUP_BLOCKS
    return _smem_bytes(n, 4 * (n + 3 * nb + ng), n_lights)


def _smem_bytes(n: int, table_floats: int, n_lights: int) -> int:
    smem = 4 * (table_floats + 12 + n_lights)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{n} spheres need {smem} B of shared memory (> {_MAX_SMEM_BYTES})")
    return smem


def _check_cuda_inputs(scene_tab, cam_tab, s0, s1, acc, light_indices, table_floats, rng):
    dev = s0.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if rng not in ("mwc", "counter"):
        raise ValueError(f"unknown rng {rng!r}")
    for name, t, dtype in (
        ("scene_tab", scene_tab, torch.float32),
        ("cam_tab", cam_tab, torch.float32),
        ("s0", s0, torch.uint32),
        ("s1", s1, torch.uint32),
        ("acc", acc, torch.float32),
    ):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor on {dev}, got "
                f"{t.dtype} on {t.device}"
            )
    rp = s0.shape[0]
    n = scene_tab.shape[1]
    if s0.dim() != 1 or s1.shape != s0.shape or acc.numel() != 3 * rp or acc.shape[0] != 3:
        raise ValueError(f"state shapes {s0.shape}, {s1.shape}, {acc.shape} disagree")
    if scene_tab.shape[0] != 12 or cam_tab.numel() != 12:
        raise ValueError(f"scene_tab {tuple(scene_tab.shape)} / cam_tab {tuple(cam_tab.shape)}")
    _smem_bytes(n, table_floats, len(light_indices))
    if any(not 0 <= i < n for i in light_indices):
        raise ValueError(f"light index out of range in {light_indices}")


def pt_multi_pass(
    scene_tab: torch.Tensor,
    cam_tab: torch.Tensor,
    start_sample: int,
    s0: torch.Tensor,
    s1: torch.Tensor,
    acc: torch.Tensor,
    pix: Optional[torch.Tensor] = None,
    *,
    num_samples: int,
    width: int,
    height: int,
    max_depth: int,
    direct_only: bool,
    light_indices: Tuple[int, ...],
    rng: str = "mwc",
    lane_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_samples`` progressive passes in ONE kernel launch: K2
    (``pt_blocked_pass``, which needs ``pix``) where ``uses_k2``, else K1
    (here). K1 takes the identity layout: ``pix`` must be None,
    and lane i traces pixel ``lane_offset + i`` (a shard of a sharded render
    passes the absolute id of its first lane). K2 reads absolute pixel ids
    from ``pix`` and takes no offset.

    Tensors on the CPU take ``pt_pass_reference``; tensors on a CUDA device
    launch the kernel on the current stream (or raise). Inputs are not
    modified: the kernel writes fresh (s0, s1, acc) tensors.
    ``pt_multi_pass.launches`` counts K1 launches."""
    refuse_grad("pt_multi_pass", scene_tab, cam_tab, acc)
    kw = dict(
        num_samples=num_samples, width=width, height=height,
        max_depth=max_depth, direct_only=direct_only,
        light_indices=tuple(light_indices), rng=rng,
    )
    if uses_k2(scene_tab.shape[1]):
        if pix is None:
            raise ValueError("K2 needs the lane -> pixel table pix of ray_layout(blocked=True)")
        if lane_offset:
            raise ValueError("K2 reads absolute pixel ids from pix: pass lane_offset=0")
        return pt_blocked_pass(scene_tab, cam_tab, start_sample, s0, s1, acc, pix, **kw)
    if pix is not None:
        raise ValueError("K1 runs the identity layout: pass pix=None")
    if s0.device.type == "cpu":
        return pt_pass_reference(scene_tab, cam_tab, start_sample, s0, s1, acc,
                                 lane_offset=lane_offset, **kw)
    with span("pt.launch"):
        # K1's shared memory: a (center, radius) record per sphere and the table.
        _check_cuda_inputs(scene_tab, cam_tab, s0, s1, acc, light_indices,
                           16 * scene_tab.shape[1], rng)
        lib = _kernel_lib()
        lights = light_list(light_indices, s0.device)
        outs = (torch.empty_like(s0), torch.empty_like(s1), torch.empty_like(acc))
        err = lib.pt_multi_pass_cuda(
            scene_tab.data_ptr(), scene_tab.shape[1], lights.data_ptr(), len(light_indices),
            cam_tab.data_ptr(), int(start_sample), int(num_samples),
            s0.data_ptr(), s1.data_ptr(), acc.data_ptr(), *(t.data_ptr() for t in outs),
            *_frame_args(s0, width, height, max_depth, direct_only, rng), int(lane_offset),
        )
    if err != 0:
        raise RuntimeError(f"pt_multi_pass_cuda launch failed: cudaError {err}")
    pt_multi_pass.launches += 1
    return outs


pt_multi_pass.launches = 0


def pt_blocked_pass(
    scene_tab: torch.Tensor,
    cam_tab: torch.Tensor,
    start_sample: int,
    s0: torch.Tensor,
    s1: torch.Tensor,
    acc: torch.Tensor,
    pix: torch.Tensor,
    *,
    num_samples: int,
    width: int,
    height: int,
    max_depth: int,
    direct_only: bool,
    light_indices: Tuple[int, ...],
    rng: str = "mwc",
    cull: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: ``num_samples`` passes in ONE launch, for any number of spheres,
    over the lanes of ``pix`` (int32, ``ray_layout(blocked=True)``). The
    sweep runs in blocks of ``SPHERE_BLOCK``, grouped ``GROUP_BLOCKS`` at a
    time; ``cull`` skips the remainder, a group, a block or a half block
    whose bound (``remainder_bound``, ``group_bounds``, ``block_bounds``,
    ``half_bounds``) the ray cannot hit, or enters beyond the best hit so
    far (at or beyond the light, for a shadow ray), with the same result
    bits as ``cull=False``. CPU tensors take ``pt_pass_reference``.
    ``pt_blocked_pass.launches`` counts K2 launches."""
    refuse_grad("pt_blocked_pass", scene_tab, cam_tab, acc)
    kw = dict(
        num_samples=num_samples, width=width, height=height,
        max_depth=max_depth, direct_only=direct_only,
        light_indices=tuple(light_indices), rng=rng,
    )
    if s0.device.type == "cpu":
        return pt_pass_reference(scene_tab, cam_tab, start_sample, s0, s1, acc, pix, **kw)
    halves, bounds, groups, rest, lights = _k2_tables(scene_tab, tuple(light_indices))
    with span("pt.launch"):
        nb, ng = bounds.shape[1], groups.shape[1]
        # K2's shared memory: a (center, radius) record per sphere and per
        # half block, block and group bound.
        _check_cuda_inputs(scene_tab, cam_tab, s0, s1, acc, light_indices,
                           4 * (scene_tab.shape[1] + 3 * nb + ng), rng)
        if pix.device != s0.device or pix.dtype != torch.int32 or pix.shape != s0.shape:
            raise ValueError(f"pix: need int32 [{s0.shape[0]}] on {s0.device}")
        pix = pix.contiguous()
        lib = _k2_lib()
        outs = (torch.empty_like(s0), torch.empty_like(s1), torch.empty_like(acc))
        err = lib.pt_blocked_pass_cuda(
            scene_tab.data_ptr(), scene_tab.shape[1], halves.data_ptr(), bounds.data_ptr(), nb,
            groups.data_ptr(), ng, rest.data_ptr(), int(cull),
            pix.data_ptr(), lights.data_ptr(), len(light_indices),
            cam_tab.data_ptr(), int(start_sample), int(num_samples),
            s0.data_ptr(), s1.data_ptr(), acc.data_ptr(), *(t.data_ptr() for t in outs),
            *_frame_args(s0, width, height, max_depth, direct_only, rng),
        )
    if err != 0:
        raise RuntimeError(f"pt_blocked_pass_cuda launch failed: cudaError {err}")
    pt_blocked_pass.launches += 1
    return outs


pt_blocked_pass.launches = 0


def _k2_tables(scene_tab: torch.Tensor, light_indices: Tuple[int, ...]):
    """(half-block, block, group and remainder bounds, int32 light list) of a
    scene table, kept per table and light tuple (``derived``; a render's
    table is ``scene_table``'s). A build is ~30 small ops and no host copy.
    Spans ``pt.k2_tables`` the lookup and ``pt.k2_tables.build`` a build."""

    def build():
        with span("pt.k2_tables.build"):
            return (half_bounds(scene_tab), block_bounds(scene_tab), group_bounds(scene_tab),
                    remainder_bound(scene_tab), light_list(light_indices, scene_tab.device))

    with span("pt.k2_tables"):
        return derived("k2_tables", (scene_tab,), (tuple(light_indices),), build)


def light_list(light_indices, device) -> torch.Tensor:
    """The int32 light list on ``device`` (``device_copy``)."""
    return device_copy(light_indices, torch.int32, device)


def _frame_args(s0, width, height, max_depth, direct_only, rng):
    """The trailing arguments the two C entry points share."""
    return (
        s0.shape[0], width, height,
        float(np.float32(1.0 / width)), float(np.float32(1.0 / height)),
        max_depth, int(direct_only), int(rng == "counter"),
        torch.cuda.current_stream(s0.device).cuda_stream,
    )


def _kernel_lib() -> ctypes.CDLL:
    """K1's library: csrc/pt_kernel.cu."""
    from se195_raytracer_tpu_torch.kernels._build import load

    return _bind(load("pt_kernel"))


def _k2_lib() -> ctypes.CDLL:
    """K2's library: csrc/pt_kernel.cu built with PT_K2_ROUNDED
    (csrc/pt_blocked_kernel.cu)."""
    from se195_raytracer_tpu_torch.kernels._build import load

    return _bind(load("pt_blocked_kernel"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.pt_multi_pass_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [p, p, p, p, p, p, i, i, i, f, f, i, i, i, p]
        lib.pt_multi_pass_cuda.argtypes = [p, i, p, i, p, i, i] + tail + [i]
        lib.pt_blocked_pass_cuda.argtypes = [p, i, p, p, i, p, i, p, i, p, p, i, p, i, i] + tail
        lib.pt_multi_pass_cuda.restype = lib.pt_blocked_pass_cuda.restype = ctypes.c_int
    return lib


def init_pt_state(config, device, blocked: bool = False,
                  tile_multiple: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fresh (s0, s1, acc) over the Rp lanes of ``lane_layout`` on
    ``device`` (``Layout.seed``; the seed kernel on a CUDA device). The real
    pixels get the plain path's seeds and the pad lanes the inert seed 2
    (the least valid MWC seed; counter key = ctr = 2), as render_pallas
    does: bitwise ``init_pt_state_host``."""
    layout = lane_layout(config.width, config.height, blocked, tile_multiple, device)
    return layout.seed(config, 0, layout.rp, device)


def init_pt_state_host(config, device, blocked: bool = False,
                       tile_multiple: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``init_pt_state`` as the JAX package makes it: numpy's draw of the
    whole frame on the host, padded and permuted there, then copied to
    ``device``. The oracle the seed kernel is held to."""
    r = config.width * config.height
    rp, pix, _ = ray_layout(config.width, config.height, blocked, tile_multiple)
    s0, s1 = init_state(config.rng, (r,), config.seed, device="cpu")
    pad = torch.full((max(rp - r, 1),), 2, dtype=torch.uint32)
    if blocked:
        lanes = torch.from_numpy(pix).to(torch.int64)
        s0, s1 = torch.cat([s0, pad[:1]])[lanes], torch.cat([s1, pad[:1]])[lanes]
    else:
        s0, s1 = torch.cat([s0, pad[: rp - r]]), torch.cat([s1, pad[: rp - r]])
    acc = torch.zeros((3, rp // LANES, LANES), dtype=torch.float32, device=device)
    return s0.to(device), s1.to(device), acc


def pixel_range(config, pixels: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """(lo, hi) of ``pixels``, the whole frame for None; raises outside it."""
    n = config.width * config.height
    lo, hi = (0, n) if pixels is None else pixels
    if not 0 <= lo < hi <= n:
        raise ValueError(f"pixels={pixels}: a range inside 0..{n}")
    return lo, hi


class Frame(NamedTuple):
    """The kernels' inputs for a render (``prepare_frame``)."""

    layout: Layout
    scene_tab: torch.Tensor
    cam_tab: torch.Tensor
    light_indices: Tuple[int, ...]


def prepare_frame(scene: Scene, camera: Camera, config, shards: int, device) -> Frame:
    """The kernels' inputs for a render of ``scene`` through ``camera`` (on
    ``device``) in ``shards`` shards of whole tiles: the layout of the
    kernel ``uses_k2`` picks, the scene's table and the camera's row (made
    per call). Spans ``pt.pack_scene`` and ``pt.camera``. The relaxed
    estimator raises: the kernels implement the hard one."""
    if config.soft_edges > 0.0:
        raise NotImplementedError(
            "soft_edges > 0: K1 and K2 implement the hard estimator; render the relaxed "
            "one on the plain path (use_kernel=False, render_sharded)")
    w, h = config.width, config.height
    layout = lane_layout(w, h, uses_k2(scene.num_spheres), shards, device)
    with span("pt.pack_scene"):
        scene_tab = scene_table(scene)
    with span("pt.camera"):
        cam_tab = pack_camera(update_camera(camera, w, h))
    return Frame(layout, scene_tab, cam_tab, scene.light_indices)


def trace_lanes(frame: Frame, config, spp: int, state: PTState, pix: Optional[torch.Tensor],
                lane_offset: int) -> PTState:
    """``spp`` passes from ``state`` over the lanes ``pix`` or
    ``lane_offset`` name, in one ``pt_multi_pass`` launch."""
    s0, s1, acc, start = state
    s0, s1, acc = pt_multi_pass(
        frame.scene_tab, frame.cam_tab, start, s0, s1, acc, pix,
        num_samples=spp, width=config.width, height=config.height, max_depth=config.max_depth,
        direct_only=config.integrator == "dl", light_indices=frame.light_indices,
        rng=config.rng, lane_offset=lane_offset,
    )
    return s0, s1, acc, start + spp


def render_cuda(
    scene: Scene,
    camera: Camera,
    config,
    num_samples: Optional[int] = None,
    state: Optional[PTState] = None,
    device=None,
    pixels: Optional[Tuple[int, int]] = None,
):
    """Progressive render through K1, or K2 where ``uses_k2`` (twin of
    ``render_pallas``).

    Returns (image [H, W, 3] float32, (s0, s1, acc, sample) state). On a
    CUDA device the passes run in the kernel; on the CPU in its plain
    version. ``device=None`` means CUDA and raises if there is none. Inputs
    that require a gradient raise (``kernels/_guard.py``): differentiate
    through ``driver.optimize.render_differentiable``.

    ``pixels=(lo, hi)`` renders only the row-major pixels lo..hi-1, from
    the fresh seeds the whole frame gives them (K1 at lane offset lo, K2
    over pix = lo..hi-1), and returns their [hi - lo, 3] rows in place of
    the image: the forward of a shard of a sharded differentiable render.

    Under a profiler session the call is a ``pt.render`` span holding
    ``pt.pack_scene``, ``pt.camera`` (``update_camera`` and
    ``pack_camera``), ``pt.seed``, K2's ``pt.k2_tables``, ``pt.launch`` and
    ``pt.gather`` (``utils.profiling.span``)."""
    refuse_grad("render_cuda", scene, camera, None if state is None else state[2])
    with span("pt.render"):
        device = resolve_device(device)
        frame = prepare_frame(scene.to(device), camera.to(device), config, 1, device)
        layout, r = frame.layout, config.width * config.height
        spp = config.spp if num_samples is None else num_samples
        if pixels is None:
            if state is None:
                with span("pt.seed"):
                    state = init_pt_state(config, device, layout.blocked) + (0,)
            state = trace_lanes(frame, config, spp, state, *layout.lanes(0, layout.rp))
            with span("pt.gather"):
                return layout.image(state[2], config.width, config.height), state
        if state is not None:
            raise ValueError(f"pixels={pixels}: rendered from fresh seeds (state=None)")
        lo, hi = pixel_range(config, pixels)
        with span("pt.seed"):
            s0, s1 = seed_lanes(config.rng, config.seed, r, hi - lo, lane_offset=lo,
                                device=device)
            acc = torch.zeros((3, hi - lo), dtype=torch.float32, device=device)
        pix = torch.arange(lo, hi, dtype=torch.int32, device=device) if layout.blocked else None
        state = trace_lanes(frame, config, spp, (s0, s1, acc, 0), pix, 0 if pix is not None else lo)
        with span("pt.gather"):
            return state[2].T, state
