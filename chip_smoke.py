"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds every kernel from
   kernels/csrc/ with nvcc (sm_90a, one process per source) and prints the
   build time and each kernel's ptxas registers, stack frame and spills;
2. K1 (csrc/pt_kernel.cu, small scenes) against its plain PyTorch version
   (pt_pass_reference) on the card: Cornell 512x512, 1 spp, for PT/mwc,
   DL/mwc and PT/counter, and progressive resume (1+1 vs 2 spp);
3. the Cornell main path: ``cli.main(["render", ...])`` and
   ``driver.render.render`` at 512x512, 8 spp, with every launch counter set
   to 0 just before and read just after (one seeding in the seed kernel and
   one K1 launch per render); the image against the plain mean;
4. K1 timing: kernel (PT, and DL), end to end with readback (and in turns
   against numpy's seed route), plain, bound, and the breakdown of
   ``render_cuda`` step by step (lane tables, ``scene.to``, seed init,
   pack, light list, kernel, gather, readback; beside them the steps this
   slice replaced: numpy's seeds, the per-launch light-list and pix/inv
   copies);
4s. the seed kernel (csrc/seed_kernel.cu) bitwise against numpy's draw at
   512x512 on seeds 0, 125, 2425 and 2508 (the last three reject a word),
   mwc and counter, K1 and K2 layouts, whole and in 8 shards; its plain
   version on the card bitwise; the tail past the pass at slack 0 (seeds
   125, 2425, 2508, both layouts, whole and in 8 shards) bitwise; no host
   sync in ``seed_lanes`` or ``init_pt_state`` (CUDA sync check "error");
   its device time by the design's passes, the wrapper's time,
   ``init_pt_state`` on both routes, the plain version's time and the
   bytes bound;
5. K2 (csrc/pt_kernel.cu, the blocked, culled sweep) against the plain
   version on ``complex`` (783 spheres) at 512x512, 1 spp, PT/mwc and
   PT/counter; cull on against cull off, bitwise, at 512x512, 1 spp;
6. the complex783 main path (CLI and ``render``, 512x512, 8 spp: one K2
   launch and one seeding per render, no K1 launch) and K2 timing, the
   breakdown and the in-turns end to end as in 4, its bound counted from
   the per-ray culled work of the plain version, K2's own per-ray tests
   beside it, and the K2 split (max_depth 1 and 7, PT and DL, cull on and
   off, each with its work count);
7. K3 (csrc/whitted_kernel.cu) against the plain Whitted tracer on room and
   grid at 800x600, 3x3, depth 5, through the explicit-ray entry and the
   frame entry, for hit_bias 0 and 0.005;
8. the Whitted main path (CLI and ``render_whitted``, room 800x600 3x3:
   one K3 launch per render), K3 timing and the K3 split (trace_depth 1, 2,
   5 x supersample 1, 3, each with the plain tracer's live nodes);
9. K5 (the texel fetch of csrc/whitted5_kernel.cu, alone) against
   models/whitted5._texel, bitwise, in both forms of its texel units: the
   procedural room5 textures (float RGBA) and 2 x 200 x 200 u8/256 ones
   written as TGA files and read through io/tga.py (u8 quads), each on three
   lane sets: 2^18 and 2^22 random lanes and K4's own fetches at room5
   800x600 spp 1 (the plain tracer's ``on_texel``); each timed (device
   time, and back-to-back launches) beside its bound, its plain version and
   the torch gather; the K4 stream once more with every lane dead;
10. K4 (csrc/whitted5_kernel.cu) against the plain tracer, room5 800x600,
    spp 1, seed 3, depth 4, and the deterministic scene; K4's exact box
    tests per sweep, counted by the torch mirror of its sweeps;
11. the whitted5 main paths at room5 800x600 (CLI brute and adaptive,
    render_whitted5 at spp 8, render_whitted5_4ray, the adaptive pipeline
    under the CUDA sync check), counters set to 0 before each, each held
    against its plain version; then the path of users with the reference's
    TGA assets (room5 resolving to the u8/256 200 x 200 files through
    SE195_REF_TEXTURES: the CLI at spp 8, render_whitted5 at spp 8 and K4
    at spp 1, bitwise against the plain tracer);
12. whitted5 timings at 320x240 and 800x600 for spp 1, spp 8, 4-ray and
    adaptive, with bounds from the plain tracer's live-work count, the
    adaptive against 4-ray ratio and PSNRs; the K4 split (trace_depth 1, 2,
    4 x two shadow-sample tables at 800x600 spp 1); K5's share of K4 at
    room5 800x600 spp 8 on both texture sets (K4 against a twin scene
    without texture ids, in turns);
S. the sharded paths (parallel/), 8 shards on cuda:0, each image held
   bitwise to the single-device render and timed end to end beside it (the
   cost of 8 launches on one card; no scaling claim): Cornell 512x512 x 8
   spp through K1 (8 K1 launches and 8 seedings, each shard its own
   lanes, no plain ``radiance``), complex783
   512x512 x 8 spp and 640x480 x 1 spp (2 pad tiles) through K2, Whitted
   room 800x600 3x3 through K3's explicit-ray entry against its frame
   entry, room5 800x600 spp 8 through K4; two processes on the card (gloo,
   ``initialize_multihost``, ``all_gather``) rendering Cornell 512x512 x 8
   spp, bitwise the one-process frame; sharded gradients at Cornell 128x128
   spp 1 against one device (rtol 1e-5; one K1 and one K1b launch a
   shard); the 3,908-sphere
   ``complex_scene(max_depth=5)`` at 512x512 through K2 (past 48 KB of
   shared memory) against its plain version under K2's contract, and a
   1,000-primitive Whitted scene through both K3 entries, bitwise against
   the plain tracer; a session (30 ``step_for`` calls around a camera
   edit; the image after it a fresh render from the kept seeds, bitwise);
   a checkpoint saved, loaded and resumed, bitwise; ``cli bench``'s JSON
   line; ``render --scene tests/fixtures/scenes/cornell_scn.scn
   --profile DIR``, whose trace holds K1;
G. the differentiable path (driver/optimize.py), Cornell 512x512, PT, mwc,
   seed 0: ``render_differentiable`` at spp 2 and 8 is one seeding and one
   K1 launch forward and one seeding and one K1b launch
   (csrc/pt_backward_kernel.cu) backward, with no plain ``radiance``
   either way (a counting wrapper this script installs); its image under
   K1's contract against the plain primal; its gradients (L2 to the start
   scene's image, every leaf) finite and each sphere's row within
   ``GRAD_ROW_REL`` of its own scale (``grad_row_error``) of the plain
   path's VJP of the same cotangent; K1b's replayed primal
   bitwise ``_render_plain_diff``'s (PT and DL, mwc and counter, spp 2
   and 8), K1b run twice on one cotangent bitwise (checked: no atomics,
   a fixed order of every sum); the relaxed
   estimator's route, max_depth 20 (past K1b's record) and K2's on
   ``complex`` 128x128 keep the plain backward, equal to the plain VJP
   (rtol 1e-5); the counter RNG's forward
   against its recompute; the six pixel-gradient checks of the gradient
   benchmark at 512x512 spp 2 (JVP against central finite differences,
   hard and soft 0.5, bounded but for the hard light centre); 10
   inverse-rendering steps hard (K1b's route and the plain route, their
   losses side by side) and soft; forward+backward ms per step at spp 2
   and 8, hard (split forward / K1b alone / the rest on the host, the
   plain route's step beside it) and soft, the idle share and peak memory,
   and an spp-2 plain step's peak memory with remat on and off; K1b's
   bound from the work the plain version counts on the same lanes and its
   plain version's time; whitted5 soft (room5 320x240, the plain tracer)
   and its light-position gradient;
T. last, K3's debug taps (``whitted_taps_cuda``: tres, attr and shade on
   room and grid at 800x600 3x3, hit_bias 0 and 0.005, each bitwise the
   plain ``whitted_taps``; each tap's ms beside its bound); MT19937 (1,000
   chained ``twist_torch`` + ``temper_torch`` blocks on the card from seeds
   0, 1, 5489 and 0xF2710812, bitwise numpy); room5's floor texture
   recovered at 160x120 for 5 steps through
   examples/whitted5_texture_recovery_torch.py (loss and seen-texel MAE
   fall), the step ms, the idle share over a step, the peak memory, and the
   first gradient at 40x30 on the card against the CPU's (within 1e-5 of
   its scale); the K3 entry of the kernels line gains the taps' launches
   and ms;
13. prints the grad phase's numbers (``{"grad": {...}}``), the sharded
    phase's (``{"sharded": {...}}``), phase T's (``{"taps"}``,
    ``{"mt19937"}``, ``{"texrec"}``), one JSON line per kernel
    (``{"kernels": [...]}``, K1-K5, the seed kernel and K1b, K1 and K2 with their launches
    per differentiable forward, K1b with its launches per differentiable
    step and per 8-shard gradient, its spp-8 time, bound and share, its
    spp-8 / spp-2 ratio, its registers and stack frame (ptxas's figures,
    read from the loaded library for each integrator and RNG), its resident
    warps an SM and ``repeat_bitwise``
    (checked), each other with its launches in the
    sharded render that runs it, as counted there; K5's are the room5 K4
    launches it ran inside)
    and, last, ``{"ok": true, "device": {...}}``.

``--only-grad`` builds the kernels and runs K1's first check and the grad
phase only; ``--only-sharded`` the sharded phase only; ``--only-t`` phase
T only; ``--only-seed`` phases 2-4 and 4s only.

Any failed check exits non-zero before the last line. Imports nothing of
JAX or of the JAX package. Exits non-zero without a result when no CUDA
device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SCENE = "cornell"
WIDTH = HEIGHT = 512
SPP = 8
SEED = 0
REPS = 7
# Same contract as the CPU parity tests (tests/test_pallas_kernel.py): torch
# and CUDA sin/cos/sqrt differ by ulps and FMA contraction moves roundings,
# which can flip a Russian-roulette or total-internal-reflection decision.
CLOSE_RTOL = CLOSE_ATOL = 2e-3
MAX_MISMATCH = 0.03  # share of components outside isclose
MEAN_RTOL = 2e-3
MAX_STATE_MISMATCH = 0.01  # share of lanes whose RNG state differs
RESUME_TOL = 1e-5
MAIN_MEAN_RTOL = 0.01
# K3 against its plain version on the 0..255 frame: the bound that
# tests/test_pallas_kernel.py:96 sets for the TPU kernel against jnp.
W_RTOL, W_ATOL = 1e-3, 2e-2
WHITTED = dict(width=800, height=600, supersample=3, trace_depth=5)
COMPLEX = "complex"
# Roofline inputs: published H100 SXM peaks (NVIDIA data sheet), FP32
# outside the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
STATE_BYTES_PER_LANE = 40  # s0, s1, acc: 20 B read + 20 B written per call
# FP32 ops per unit of work, counted from the kernels' sources (lower
# figures where an op count is unsure, so that a bound stays a bound).
OPS_CAMERA = 25  # per primary sample
OPS_SHADE = 70  # per live bounce: hit point, normal, material branch, RNG
OPS_SHADOW_SETUP = 45  # per shadow ray: light sample, direction, weights
OPS_SPHERE_NEAREST = 15  # per sphere test of a nearest sweep
OPS_SPHERE_SHADOW = 12  # per sphere test of a shadow sweep
OPS_BOUND = 14  # per block-bound test (block_possible)
# K1b's reverse sweep, FP32 ops counted from csrc/pt_backward_kernel.cu
# (lower figures where unsure): per recorded bounce (the hit frame
# recomputed, the adjoints of the normal, the hit distance and the branch),
# per light sample whose shadow ray passed (recomputed and differentiated),
# per camera ray; and the bytes a lane must move (its two seed words and its
# cotangent in).
OPS_ADJ_BOUNCE = 150
OPS_ADJ_LIGHT = 90
OPS_ADJ_CAMERA = 40
K1B_BYTES_PER_LANE = 8 + 12
# K1b's replay must round as the plain path does (no FMA contraction), so
# each of its products and sums is an instruction of its own: half the FMA
# rate's 67 TFLOP/s. Its reverse sweep has no such need, so its bound takes
# the FMA rate.
PEAK_FP32_OPS_NO_FMA = PEAK_FP32_FLOPS / 2
W_OPS_PLANE, W_OPS_SPHERE = 15, 20  # per primitive test of a Whitted sweep
W_OPS_LIGHT = 45  # per light of a lit Whitted node: direction, N.L, Phong
W_OPS_NODE = 40  # per live Whitted node: hit point, normal, contribution, children
# whitted5 (K4): FP32 ops per primitive test of a sweep (a box is 6 slab faces
# of ~20), per live node, per light of a lit node, per shadow-sample setup
# (two counter draws, the grid point, the direction), per texel fetch (uv
# mapping, index math, 4-corner blend) and per glossy disc sample.
W5_OPS_SPHERE, W5_OPS_PLANE, W5_OPS_BOX = 20, 15, 120
W5_OPS_NODE = 60
W5_OPS_LIGHT = 45
W5_OPS_SAMPLE = 40
W5_OPS_TEXEL = 60
W5_OPS_GLOSSY = 50
K5_OPS_LANE = 40  # per K5 lane: index math and the 3-channel blend
K5_BYTES_LANE = 4 + 4 + 4 + 1 + 12  # tex, u, v, live in; 3 floats out
# K5's lane sets: random lanes (2^18, and 2^22 where the bound is well
# above a launch's latency) and K4's own fetches (K5_STREAM); the kernels
# line reports K5_HEADLINE.
K5_RANDOM = {"random 2^18": 1 << 18, "random 2^22": 1 << 22}
K5_STREAM = "K4 stream"
K5_HEADLINE = ("u8", "random 2^22")
W5_SIZES = ((320, 240), (800, 600))
W5_SPP = 8
W5_SEED = 3
# K4 against its plain version (the contract tests/test_whitted5_kernel.py
# sets the TPU kernel against jnp, tightened): p99 of |diff|, the share of
# components outside isclose(1e-3, 1e-3), the image mean, the primary hits.
K4_P99, K4_BAD, K4_MEAN_RTOL, K4_IDX = 1e-4, 1e-3, 1e-4, 0.9999
K4_DET_TOL = 1e-5

# The differentiable path (the grad phase): Cornell 512x512, PT, mwc, seed 0,
# max_depth 7, forward on K1 (K2 on complex at GRAD_K2 = (w, h, spp)), the
# backward the plain path's autograd. Steps at GRAD_SPPS; the relaxation at
# GRAD_SOFT; GRAD_STEPS inverse-rendering steps each hard and soft with the
# gradient benchmark's optimizer (GRAD_LR, geometry at GRAD_GEOM_MULT x, a
# cosine decay to GRAD_ALPHA); whitted5 soft on room5 at W5_GRAD.
GRAD_SPPS = (2, 8)
GRAD_SOFT = 0.5
GRAD_DEEP = (20, 64)  # max_depth past K1b's 16-bounce record, frame side
GRAD_K2 = (128, 128, 1)
GRAD_STEPS = 10
GRAD_LR, GRAD_ALPHA = 0.15, 0.25
GRAD_GEOM_MULT = {"hard": 10.0, "soft": 3.0}
W5_GRAD = dict(width=320, height=240, spp=1, soft=0.3, light=4)
# A gradient of a route whose backward is the plain path's autograd (the
# relaxed estimator; K2's scenes) against the plain path's VJP of the same
# cotangent: bitwise where the card's scatter-adds (the backward of
# ``scene.center[hid]``) are run-to-run bitwise, else within rtol 1e-5 and
# atol 1e-6 of the leaf's largest gradient.
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-6
# K1b (the hard backward, at most 96 spheres) against the plain path's VJP
# of the same cotangent: pt_backward_kernel.grad_row_error, each sphere's
# row of a leaf within GRAD_ROW_REL of that row's largest gradient (floored
# at GRAD_ROW_FLOOR of the leaf's), so that a fault confined to the glass
# or the mirror sphere is not measured against the walls' gradients. Its
# replayed primal is the plain path's bitwise, so it takes every branch the
# plain path takes; the gradients then differ by the adjoint's arithmetic
# (a sqrt's derivative in float32, where the plain path takes it in float64
# and rounds) and by the order of the sums (per warp in shared memory, then
# per block, where autograd sums per sphere over all lanes). The bar sits
# between that reading and the faults tools/k1b_fault_check.py plants.
# The full-frame pixel checks: max |JVP - FD| as a % of the FD image's max.
# None: printed, not checked (the hard estimator's light centre is the
# silhouette case).
PIXEL_BOUND_PCT = {("light emission r", False): 0.1, ("light emission r", True): 0.1,
                   ("wall albedo g", False): 0.1, ("wall albedo g", True): 0.1,
                   ("light center y", False): None, ("light center y", True): 2.0}


# The seed kernel's phase: seeds checked bitwise against numpy, the three
# of them below 2600 whose first 2 * 512^2 draws reject a word included.
SEED_SEEDS = (0, 125, 2425, 2508)
# Seeds whose first 2 * 512^2 words hold one rejection: at slack 0 their
# last draw comes from the seed kernel's tail.
SEED_TAIL_SEEDS = (125, 2425, 2508)

# Diagnostic splits (one line per kernel): K3's frame at (trace_depth,
# supersample), room 800x600; K2 at (max_depth, integrator), complex783
# 512x512 x 8 spp, cull on and off.
K3_SPLIT = ((1, 1), (2, 1), (5, 1), (1, 3), (2, 3), (5, 3))
K2_SPLIT = ((1, "pt"), (7, "pt"), (7, "dl"))
# K4 at room5 800x600 spp 1: (trace_depth, area_samples_by_level).
K4_SPLIT = tuple((depth, samples) for depth in (1, 2, 4)
                 for samples in ((4, 2, 1, 1), (1, 1, 1, 1)))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ops_per_bounce(n_spheres: int, n_lights: int) -> float:
    """FP32 ops of one live K1 bounce, counted as bench.py:46-54 counts them:
    a nearest sweep (~15 ops/sphere), one shadow sweep per light (~12
    ops/sphere + ~45 setup) and ~70 ops of shading, RNG and bookkeeping."""
    return 15.0 * n_spheres + n_lights * (12.0 * n_spheres + 45.0) + 70.0


def get_spec(name):
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    return get_scene(name)


def pass_inputs(scene_name, width, height, integrator, rng, device, seed=SEED):
    """Scene table, camera row, fresh (s0, s1, acc), pix (None for K1) and
    keyword arguments of K1 or K2 at the shapes render_cuda gives them.
    ``scene_name`` is a registry name or a SceneSpec."""
    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    spec = get_spec(scene_name) if isinstance(scene_name, str) else scene_name
    scene, camera = spec.to_scene(device), spec.to_camera(device)
    cfg = RenderConfig(width=width, height=height, spp=1, seed=seed,
                       integrator=integrator, rng=rng)
    scene_tab = ptk.pack_scene(scene)
    cam_tab = ptk.pack_camera(ptk.update_camera(camera, width, height))
    blocked = ptk.uses_k2(scene.num_spheres)
    pix = torch.from_numpy(ptk.ray_layout(width, height, blocked)[1]).to(device) if blocked else None
    kw = dict(width=width, height=height, max_depth=cfg.max_depth,
              direct_only=integrator == "dl", light_indices=scene.light_indices, rng=rng)
    return scene_tab, cam_tab, ptk.init_pt_state(cfg, device, blocked), pix, kw


def compare_pass(scene_name, width, height, integrator, rng, device):
    """One pass of the kernel (through its wrapper) and of its plain version
    on the same inputs; returns (max_abs_err, mismatch, state_mismatch)."""
    import torch

    from se195_raytracer_tpu_torch.kernels.pt_kernel import pt_multi_pass, pt_pass_reference

    scene_tab, cam_tab, (s0, s1, acc), pix, kw = pass_inputs(
        scene_name, width, height, integrator, rng, device)
    k0, k1, kacc = pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=1, **kw)
    p0, p1, pacc = pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=1, **kw)
    # Every lane, pad lanes too: both sides run the same lanes.
    a = kacc.reshape(3, -1).cpu().double()
    b = pacc.reshape(3, -1).cpu().double()
    check(bool(torch.isfinite(a).all()), f"{integrator}/{rng}: kernel output not finite")
    mismatch = 1.0 - torch.isclose(a, b, rtol=CLOSE_RTOL, atol=CLOSE_ATOL).double().mean().item()
    # The counter RNG keeps its key in s0; its draw counter is s1.
    sk, sp = (k1, p1) if rng == "counter" else (k0, p0)
    state_mismatch = (sk.cpu() != sp.cpu()).double().mean().item()
    max_err = (a - b).abs().max().item()
    mean_a, mean_b = a.mean().item(), b.mean().item()
    print(f"  {scene_name} {integrator}/{rng} {width}x{height}: max_abs_err {max_err:.6g}, "
          f"mismatch {mismatch:.4%}, state mismatch {state_mismatch:.4%}, "
          f"mean {mean_a:.6f} vs plain {mean_b:.6f}")
    check(mismatch <= MAX_MISMATCH, f"{integrator}/{rng}: {mismatch:.3%} components differ")
    check(abs(mean_a - mean_b) <= MEAN_RTOL * abs(mean_b), f"{integrator}/{rng}: means differ")
    check(state_mismatch <= MAX_STATE_MISMATCH,
          f"{integrator}/{rng}: {state_mismatch:.3%} lanes differ in RNG state")
    return max_err, mismatch, state_mismatch


def k2_against_plain(spec, width=WIDTH, height=HEIGHT):
    """One 1-spp PT/mwc pass of K2 and of its plain version on the same
    inputs, the plain one in chunks of 16 tiles (each lane is independent);
    returns (mismatch, state mismatch, K2's mean, the plain mean)."""
    import torch

    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    tab, camt, (s0, s1, acc), pix, kw = pass_inputs(spec, width, height, "pt", "mwc", "cuda")
    k0, _, kacc = ptk.pt_multi_pass(tab, camt, 0, s0, s1, acc, pix, num_samples=1, **kw)
    chunk = 16 * ptk.TILE
    parts = [ptk.pt_pass_reference(tab, camt, 0, s0[a:a + chunk], s1[a:a + chunk],
                                   acc.reshape(3, -1)[:, a:a + chunk].contiguous(),
                                   pix[a:a + chunk], num_samples=1, **kw)
             for a in range(0, s0.shape[0], chunk)]
    a = kacc.reshape(3, -1).double()
    b = torch.cat([p[2] for p in parts], dim=1).double()
    mism = 1.0 - torch.isclose(a, b, rtol=CLOSE_RTOL, atol=CLOSE_ATOL).double().mean().item()
    st_mism = (k0 != torch.cat([p[0] for p in parts])).double().mean().item()
    return mism, st_mism, a.mean().item(), b.mean().item()


def check_resume(scene_name, width, height, device):
    """1 + 1 spp through the kernel equals 2 spp in one launch."""
    from se195_raytracer_tpu_torch.kernels.pt_kernel import pt_multi_pass

    scene_tab, cam_tab, (s0, s1, acc), pix, kw = pass_inputs(
        scene_name, width, height, "pt", "mwc", device)
    a = pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=1, **kw)
    a = pt_multi_pass(scene_tab, cam_tab, 1, *a, pix, num_samples=1, **kw)
    b = pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=2, **kw)
    err = (a[2] - b[2]).abs().max().item()
    print(f"  {scene_name} resume 1+1 vs 2 spp: max_abs_err {err:.3g}")
    check(err <= RESUME_TOL, f"progressive resume differs by {err}")
    check(bool((a[0] == b[0]).all() and (a[1] == b[1]).all()), "resume: RNG states differ")


def zero_counters():
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as pbk
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import seed_kernel as sk
    from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk

    for fn in (ptk.pt_multi_pass, ptk.pt_blocked_pass, wk.whitted_trace_cuda,
               wk.whitted_frame_cuda, wk.whitted_taps_cuda, w5k.whitted5_trace_cuda,
               tk.texel_fetch_cuda, sk.seed_lanes, pbk.pt_backward_cuda):
        fn.launches = 0
    w5k.whitted5_trace_cuda.texel_launches = 0
    pbk.pt_backward_cuda.lane_column_launches = 0


def read_counters():
    """Launches by kernel. K5 counts the K4 launches whose scene is textured,
    where its fetch runs inside K4, plus launches of its own entry; Seed
    counts the seed kernel's seedings (``seed_lanes``); K1b the backward's
    calls (``pt_backward_cuda``: the kernel and its fixed-order sum)."""
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as pbk
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import seed_kernel as sk
    from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk

    return {"K1": ptk.pt_multi_pass.launches, "K2": ptk.pt_blocked_pass.launches,
            "K3": (wk.whitted_trace_cuda.launches + wk.whitted_frame_cuda.launches
                   + wk.whitted_taps_cuda.launches),
            "K4": w5k.whitted5_trace_cuda.launches,
            "K5": w5k.whitted5_trace_cuda.texel_launches + tk.texel_fetch_cuda.launches,
            "Seed": sk.seed_lanes.launches, "K1b": pbk.pt_backward_cuda.launches}


# Launches by kernel in each scene's main path (run_main_path).
MAIN_LAUNCHES = {}


def run_main_path(scene_name, width, height, spp, out_png, want):
    """The user's entry points: the CLI, then driver.render.render. ``want``
    names the kernel that must run once per call, after one seeding in the
    seed kernel. Returns (image, config, launches by kernel)."""
    import torch

    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver.render import render

    argv = ["render", "--scene", scene_name, "--width", str(width), "--height",
            str(height), "--spp", str(spp), "--out", out_png]
    spec = get_spec(scene_name)
    cfg = RenderConfig(width=width, height=height, spp=spp, seed=SEED)
    zero_counters()
    rc = cli.main(argv)
    after_cli = read_counters()
    img, _ = render(spec.to_scene(), spec.to_camera(), cfg)
    launches = read_counters()
    check(rc == 0, f"cli render exited {rc}")
    with open(out_png, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "cli output is not a PNG")
    check(tuple(img.shape) == (height, width, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "main-path image not finite")
    check(img.mean().item() > 0.0, "main-path image is black")
    others = {k: v for k, v in launches.items() if k not in (want, "Seed")}
    check(after_cli[want] == after_cli["Seed"] == 1 and launches[want] == launches["Seed"] == 2
          and not any(others.values()),
          f"launches: cli {after_cli}, total {launches} (want one {want} and one Seed per call, "
          "nothing else)")
    MAIN_LAUNCHES[scene_name] = launches
    return img, cfg, launches


def designed_in(kernel: str) -> str | None:
    """The change that last designed ``kernel`` ("K1" .. "K5"): the last
    "PR n" in the Status column of its row in PERF.md's kernel table, the
    record that names it. None in a checkout that carries no PERF.md (the
    program needs none of the documents); fails when the file is there and
    its row or the name is missing."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "PERF.md")
    if not os.path.exists(path):
        print(f"  no PERF.md beside the script: designed_in of {kernel} is null",
              file=sys.stderr)
        return None
    with open(path) as f:
        rows = [line.split("|") for line in f if line.startswith(f"| {kernel} |")]
    found = re.findall(r"PR \d+", rows[0][3]) if rows else []
    check(bool(found), f"PERF.md's kernel table names no PR in {kernel}'s Status column")
    return found[-1]


def ptxas_summary(log: str):
    """(kernel, registers, stack frame bytes, spill store bytes, spill load
    bytes) for each entry function in an ``nvcc -Xptxas -v`` log; template
    arguments shown as <a,b,...> (1 = true)."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled, i, parts = m.group(1), 3 if m.group(1).startswith("_ZN") else 2, []
            while (num := re.match(r"\d+", mangled[i:])):  # length-prefixed name parts
                i += len(num.group(0))
                parts.append(mangled[i:i + int(num.group(0))])
                i += int(num.group(0))
            args = re.findall(r"L[bi](\d+)E", mangled[i:])
            name = (parts[-1] if parts else mangled) + (f"<{','.join(args)}>" if args else "")
            frame = None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))) + (frame or (0, 0, 0)))
            name = None
    return rows


def print_ptxas(logs, tag=""):
    for src, log in logs.items():
        for name, regs, frame, st, ld in ptxas_summary(log):
            print(f"  ptxas {tag}{src} {name}: {regs} registers, {frame} B stack frame, "
                  f"{st} B spill stores, {ld} B spill loads")
        for line in log.splitlines():
            if "error" in line.lower() or "warning" in line.lower():
                print(f"  nvcc {tag}{src}: {line.strip()}")


def k3_split(scene, width, height, works):
    """K3's frame ms at each (trace_depth, supersample) of K3_SPLIT beside
    the plain tracer's live nodes (``works``: {(depth, ss): work}, filled
    where missing). Time per live node that grows with depth means
    divergence; time that follows the nodes, the cost per node. Returns the
    rows."""
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.models import whitted as W

    rows = {}
    for depth, ss in K3_SPLIT:
        work = works.get((depth, ss))
        if work is None:
            work = works[(depth, ss)] = {}
            W.render_whitted_scene(scene, width, height, ss, depth, ray_tile=1 << 20, work=work)
        ms, _ = median_ms(lambda: wk.whitted_frame_cuda(
            scene, width=width, height=height, supersample=ss, trace_depth=depth), reps=5)
        rows[f"depth{depth} ss{ss}"] = dict(ms=ms, nodes=work["nodes"],
                                            ns_per_node=ms * 1e6 / work["nodes"])
    print("  K3 split (room %dx%d): " % (width, height) + "; ".join(
        f"{k} {v['ms']:.4f} ms / {v['nodes']} live nodes = {v['ns_per_node']:.5f} ns"
        for k, v in rows.items()))
    return rows


def k2_split(width, height, spp, works, pass_fn=None):
    """K2's ms at each (max_depth, integrator) of K2_SPLIT, cull on and off,
    beside ``culled_work_counter``'s counts of the same render (the JAX
    algorithm's per-ray culled work and K2's own per-ray tests; ``works``:
    {(max_depth, integrator): work}, filled where missing).
    ``pass_fn(scene_tab, cam_tab, s0, s1, acc, pix, cull, **kw)`` runs K2
    (default ``pt_blocked_pass``). Returns the rows."""
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    if pass_fn is None:
        def pass_fn(scene_tab, cam_tab, s0, s1, acc, pix, cull, **kw):
            return ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, cull=cull, **kw)
    rows = {}
    for max_depth, integ in K2_SPLIT:
        scene_tab, cam_tab, (s0, s1, acc), pix, kw = pass_inputs(
            COMPLEX, width, height, integ, "mwc", "cuda")
        kw.update(max_depth=max_depth, num_samples=spp)
        work = works.get((max_depth, integ))
        if work is None:
            hook, work = ptk.culled_work_counter(scene_tab)
            ptk.pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, pix, on_sweep=hook, **kw)
            works[(max_depth, integ)] = work
        on, _ = median_ms(lambda: pass_fn(scene_tab, cam_tab, s0, s1, acc, pix, True, **kw), reps=5)
        off, _ = median_ms(lambda: pass_fn(scene_tab, cam_tab, s0, s1, acc, pix, False, **kw),
                           reps=3)
        rays = work["nearest_rays"] + work["shadow_rays"]
        tests = work["nearest_tests"] + work["shadow_tests"]
        own = work["kernel_nearest_tests"] + work["kernel_shadow_tests"]
        rows[f"{integ} max_depth {max_depth}"] = dict(ms=on, nocull_ms=off, work=work)
        print(f"  K2 split {integ} max_depth {max_depth}: cull on {on:.4f} ms, off {off:.4f} ms; "
              f"{work['nearest_rays']} nearest + {work['shadow_rays']} shadow sweeps; per sweep "
              f"{tests / rays:.2f} sphere + {work['bound_tests'] / rays:.2f} bound tests (JAX "
              f"culled work), K2's own {own / rays:.2f} sphere + "
              f"{work['kernel_bound_tests'] / rays:.2f} block + "
              f"{work['kernel_group_tests'] / rays:.2f} group tests; "
              f"{on * 1e6 / max(tests, 1):.5f} ns per culled-work sphere test")
    return rows


def k4_split(scene, width, height, works):
    """K4's ms at room5 ``width`` x ``height``, spp 1, for each
    (trace_depth, area_samples_by_level) of K4_SPLIT, beside the plain
    tracer's live nodes and the shadow sweeps K4 traces (those that can add
    light; ``works``: {(depth, samples): work}, filled where missing). The
    two sample tables differ only in the shadow sweeps of level 1, so at
    each depth the difference of the two rows gives the ns per traced
    shadow sweep, and the rest of the row's time per live node the ns per
    node (its nearest sweep, its shading, the pass's slot sums). Returns
    the rows."""
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P

    o, d = P._cached_rays5(width, height, (0.5, 0.5), "cuda")
    state = P._state5(width * height, W5_SEED, "cuda")
    rows = {}
    for depth, samples in K4_SPLIT:
        work = works.get((depth, samples))
        if work is None:
            work = works[(depth, samples)] = {}
            P.trace_passes(scene, o, d, state, trace_depth=depth, area_samples_by_level=samples,
                           work=work)
        ms, _ = launch_ms(lambda: w5k.whitted5_trace_cuda(
            scene, o, d, state, trace_depth=depth, area_samples_by_level=samples))
        rows[(depth, samples)] = dict(ms=ms, nodes=work["nodes"],
                                      shadow_sweeps=work["shadow_sweeps_used"],
                                      shadow_sweeps_drawn=work["shadow_sweeps"])
    print(f"  K4 split (room5 {width}x{height}, spp 1): " + "; ".join(
        f"depth {d} samples {''.join(map(str, s))} {v['ms']:.4f} ms, {v['nodes']} nodes, "
        f"{v['shadow_sweeps']} shadow sweeps traced of {v['shadow_sweeps_drawn']}"
        for (d, s), v in rows.items()))
    for depth in sorted({d for d, _ in K4_SPLIT}):
        hi, lo = (rows[(depth, s)] for s in ((4, 2, 1, 1), (1, 1, 1, 1)))
        per_sweep = (hi["ms"] - lo["ms"]) / (hi["shadow_sweeps"] - lo["shadow_sweeps"])
        per_node = (hi["ms"] - per_sweep * hi["shadow_sweeps"]) / hi["nodes"]
        per_drawn = (hi["ms"] - lo["ms"]) / (hi["shadow_sweeps_drawn"] - lo["shadow_sweeps_drawn"])
        hi.update(ns_per_shadow_sweep=per_sweep * 1e6, ns_per_node=per_node * 1e6,
                  ns_per_drawn_shadow_sweep=per_drawn * 1e6,
                  shadow_share=per_sweep * hi["shadow_sweeps"] / hi["ms"])
        print(f"  K4 split depth {depth}: {per_sweep * 1e6:.5f} ns per traced shadow sweep "
              f"({per_drawn * 1e6:.5f} per drawn one, for a kernel that traces every one), "
              f"{per_node * 1e6:.5f} ns per live node besides; shadow sweeps "
              f"{hi['shadow_share']:.1%} of the default row")
    return {f"depth{d} samples{''.join(map(str, s))}": v for (d, s), v in rows.items()}


def median_ms(fn, reps=REPS):
    """Median over ``reps`` of one call timed with CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def host_ms(fn, reps=REPS):
    """Median over ``reps`` of one call on the host clock, synchronised
    before and after, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), times


def bound(ops, nbytes, kernel_ms, label):
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"  {label} bound: {ops:.6g} FP32 ops -> {ops_ms:.5f} ms at 67 TFLOP/s; "
          f"{nbytes} B -> {bytes_ms:.5f} ms at 3.35 TB/s; "
          f"bound {bound_ms:.5f} ms by {bound_by}, share {bound_ms / kernel_ms:.2%}")
    return bound_ms, bound_by


@contextlib.contextmanager
def numpy_seed_route():
    """Inside: ``render_cuda`` seeds through ``init_pt_state_host`` (numpy's
    draw on the host, laid out there and copied to the card), the route
    the port took before the seed kernel."""
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    kernel_route = ptk.init_pt_state
    ptk.init_pt_state = ptk.init_pt_state_host
    try:
        yield
    finally:
        ptk.init_pt_state = kernel_route


def same_as_numpy_seeds(img, scene_name, cfg):
    """The main path's image (seeded in the seed kernel) against ``render``
    seeded by numpy's route: bitwise (the kernels are deterministic)."""
    import torch

    from se195_raytracer_tpu_torch.driver.render import render

    spec = get_spec(scene_name)
    with numpy_seed_route():
        ref, _ = render(spec.to_scene(), spec.to_camera(), cfg)
    same = bool(torch.equal(img, ref))
    print(f"  image bitwise the one numpy's seeds give: {same}")
    check(same, f"{scene_name}: the image seeded in the seed kernel differs from numpy-seeded")


def paired_e2e(fn, label, reps=5):
    """``fn`` (a render read back to the host) with the seed kernel and
    with numpy's seed route, in turns (kernel, numpy, numpy, kernel), each
    ``host_ms`` over ``reps``: the medians of each route's runs."""
    runs = {"kernel": [], "numpy": []}
    for route in ("kernel", "numpy", "numpy", "kernel"):
        with numpy_seed_route() if route == "numpy" else contextlib.nullcontext():
            runs[route] += host_ms(fn, reps)[1]
    out = {f"{k}_seed_ms": statistics.median(v) for k, v in runs.items()}
    out["times"] = runs
    print(f"  {label} end to end in turns: seed kernel {out['kernel_seed_ms']:.4f} ms, numpy's "
          f"seed route {out['numpy_seed_ms']:.4f} ms "
          f"({out['numpy_seed_ms'] / out['kernel_seed_ms']:.4f}x)")
    return out


def render_breakdown(scene, camera, cfg, kernel_ms, e2e_ms, label):
    """``render_cuda``'s steps at ``cfg``, each alone on the host clock
    (synchronised before and after; median of REPS), the kernel by CUDA
    events (``kernel_ms``); ``unattributed`` is what ``e2e_ms`` leaves over
    (the steps' Python glue, and the syncs they overlap with in a render).
    Beside them (``replaced``), what the steps this change replaced cost:
    numpy's seed route, the light-list copy K1 made every launch and (K2)
    the pix/inv copies every render made. ``pack_scene`` and K2's bounds
    (``_k2_tables``) are the render's lookups of the scene's kept tables."""
    import torch

    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    dev = torch.device("cuda")
    w, h = cfg.width, cfg.height
    r = w * h
    blocked = ptk.uses_k2(scene.num_spheres)
    lights = tuple(scene.light_indices)
    _, pix_np, inv_np = ptk.ray_layout(w, h, blocked)
    s0, s1, acc = ptk.init_pt_state(cfg, dev, blocked)
    inv = ptk.lane_layout(w, h, blocked, 1, dev).inv
    flat = acc.reshape(3, -1)

    def gather():
        return (flat[:, inv] if blocked else flat[:, :r]).T.reshape(h, w, 3)

    img = gather()
    steps = {
        "ray_layout": lambda: ptk.ray_layout(w, h, blocked),
        "lane_tables": lambda: ptk.lane_layout(w, h, blocked, 1, dev),
        "scene_to": lambda: (scene.to(dev), camera.to(dev)),
        "seed": lambda: ptk.init_pt_state(cfg, dev, blocked),
        "pack_scene": lambda: ptk.scene_table(scene),
        "pack_camera": lambda: ptk.pack_camera(ptk.update_camera(camera, w, h)),
    }
    if blocked:
        steps["k2_tables"] = lambda: ptk._k2_tables(ptk.scene_table(scene), lights)
    else:
        steps["lights_and_outputs"] = lambda: (ptk.light_list(lights, dev), (
            torch.empty_like(s0), torch.empty_like(s1), torch.empty_like(acc)))
    steps["gather"] = gather
    steps["readback"] = lambda: img.cpu()
    parts = {k: host_ms(fn)[0] for k, fn in steps.items()}
    parts["kernel"] = kernel_ms
    parts["unattributed"] = e2e_ms - sum(parts.values())
    replaced = {
        "seed_numpy_route": host_ms(lambda: ptk.init_pt_state_host(cfg, dev, blocked))[0],
        "light_list_copy": host_ms(
            lambda: torch.tensor(lights, dtype=torch.int32, device=dev))[0],
    }
    if blocked:
        replaced["pix_inv_copies"] = host_ms(lambda: (torch.from_numpy(pix_np).to(dev),
                                                      torch.from_numpy(inv_np).to(dev)))[0]
    print(f"  {label} breakdown of {e2e_ms:.4f} ms (host clock, medians, each step alone): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    print(f"  {label} steps this change replaced: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in replaced.items()))
    return parts, replaced


def k1_section():
    """Phases 2-4: K1 parity, the Cornell main path, K1 timing."""
    import torch

    from se195_raytracer_tpu_torch.driver.render import render
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels.pt_kernel import pt_multi_pass, pt_pass_reference

    print("[2] K1 against pt_pass_reference on the card")
    errs = [compare_pass(SCENE, WIDTH, HEIGHT, integ, rng, "cuda")
            for integ, rng in (("pt", "mwc"), ("dl", "mwc"), ("pt", "counter"))]
    check_resume(SCENE, WIDTH, HEIGHT, "cuda")
    torch.cuda.synchronize()

    print(f"[3] main path: {SCENE} {WIDTH}x{HEIGHT} spp={SPP}")
    with tempfile.TemporaryDirectory() as tmp:
        img, cfg, launches = run_main_path(
            SCENE, WIDTH, HEIGHT, SPP, os.path.join(tmp, "cornell.png"), "K1")
    torch.cuda.synchronize()
    print(f"  launches during the main path: {launches}")
    same_as_numpy_seeds(img, SCENE, cfg)
    scene_tab, cam_tab, (s0, s1, acc), _, kw = pass_inputs(
        SCENE, WIDTH, HEIGHT, "pt", "mwc", "cuda")
    live = []

    def count_live(o, d, mask, max_t):
        if max_t is None:
            live.append(mask.sum())

    _, _, pacc = pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc,
                                   num_samples=SPP, on_sweep=count_live, **kw)
    r = WIDTH * HEIGHT
    plain_mean = pacc.reshape(3, -1)[:, :r].mean().item()
    kernel_mean = img.mean().item()
    live_bounces = int(sum(int(x) for x in live))
    print(f"  image mean {kernel_mean:.6f} vs plain {plain_mean:.6f}; "
          f"live bounces {live_bounces} ({live_bounces / (r * SPP):.3f} per sample)")
    check(abs(kernel_mean - plain_mean) <= MAIN_MEAN_RTOL * abs(plain_mean),
          "8-spp image mean differs from the plain version by more than 1%")

    print("[4] K1 timing")
    spec = get_spec(SCENE)
    scene, camera = spec.to_scene(), spec.to_camera()
    kernel_ms, kernel_all = median_ms(
        lambda: pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, num_samples=SPP, **kw))
    plain_ms, plain_all = median_ms(
        lambda: pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, num_samples=SPP, **kw),
        reps=5)
    dl_tab, dl_cam, dl_state, _, dl_kw = pass_inputs(SCENE, WIDTH, HEIGHT, "dl", "mwc", "cuda")
    dl_ms, dl_all = median_ms(
        lambda: pt_multi_pass(dl_tab, dl_cam, 0, *dl_state, num_samples=SPP, **dl_kw))
    torch.cuda.reset_peak_memory_stats()
    e2e_ms, e2e = host_ms(lambda: render(scene, camera, cfg)[0].cpu())
    peak_mem = torch.cuda.max_memory_allocated()
    e2e_pair = paired_e2e(lambda: render(scene, camera, cfg)[0].cpu(), "Cornell")
    # Where the end-to-end time goes: render_cuda's steps, one at a time.
    parts, replaced = render_breakdown(scene.to("cuda"), camera.to("cuda"), cfg, kernel_ms,
                                       e2e_ms, "Cornell")
    rays = WIDTH * HEIGHT * SPP
    ops = OPS_CAMERA * rays + live_bounces * ops_per_bounce(
        scene.num_spheres, len(scene.light_indices))
    print(f"  K1 kernel: {kernel_ms:.4f} ms per {SPP}-spp call (reps {['%.4f' % t for t in kernel_all]}), "
          f"{rays / kernel_ms * 1e3:.4g} rays/s")
    print(f"  K1 kernel with DL: {dl_ms:.4f} ms per {SPP}-spp call "
          f"(reps {['%.4f' % t for t in dl_all]})")
    print(f"  end to end incl. readback: {e2e_ms:.4f} ms (reps {['%.3f' % t for t in e2e]}), "
          f"{rays / e2e_ms * 1e3:.4g} rays/s")
    print(f"  plain version: {plain_ms:.3f} ms (reps {['%.3f' % t for t in plain_all]})")
    print(f"  peak memory allocated: {peak_mem} B")
    bound_ms, bound_by = bound(ops, STATE_BYTES_PER_LANE * s0.shape[0], kernel_ms, "K1")
    return {
        "name": "K1 pt_multi_pass",
        "route": "cuda",
        "designed_in": designed_in("K1"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/pt_kernel.cu",
        "replaces": "se195_raytracer_tpu/kernels/pt_kernel.py:200",
        "launches": launches["K1"],
        "max_abs_err": max(e[0] for e in errs),
        "mismatch_frac": max(e[1] for e in errs),
        "state_mismatch_frac": max(e[2] for e in errs),
        "ms": kernel_ms,
        "dl_ms": dl_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "e2e_ms": e2e_ms,
        "e2e_rays_per_s": rays / e2e_ms * 1e3,
        "kernel_rays_per_s": rays / kernel_ms * 1e3,
        "peak_mem_bytes": peak_mem,
        "breakdown_ms": parts,
        "replaced_steps_ms": replaced,
        "e2e_in_turns": e2e_pair,
    }


def seed_section():
    """Phase [4s]: the seed kernel (csrc/seed_kernel.cu) bitwise against
    numpy's draw (``init_pt_state_host``) at WIDTH x HEIGHT on SEED_SEEDS,
    mwc and counter, in K1's and K2's layouts and split in SHARDS shards of
    the ``tile_multiple=SHARDS`` layouts; the same at slack 0 on the seeds
    that reject a word (their last draw found by the pass's tail); the
    plain version on the card bitwise too; ``seed_lanes`` and
    ``init_pt_state`` under the CUDA sync check ("error"); then its device
    time by the design's passes (``queued_ms``: no profiler session, which
    would leave K5's later sessions without events): K1's layout (the one
    pass), K2's (the pass into a flat scratch and its gather), the tail at
    slack 0, the counter keys; the wrapper by CUDA events, the host time of
    ``init_pt_state`` on both routes, the plain version's time and the
    bytes bound. The launches are those of the Cornell main path (phase
    3)."""
    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import seed_kernel as sk

    n = WIDTH * HEIGHT
    print(f"[4s] seed kernel against numpy's draw: {WIDTH}x{HEIGHT}, seeds {SEED_SEEDS}, mwc "
          f"and counter, K1 and K2 layouts, whole and in {SHARDS} shards; slack 0 on "
          f"{SEED_TAIL_SEEDS}")
    worst, words = 0, 0
    cases = [(seed, rng, sk.SLACK) for seed in SEED_SEEDS for rng in ("mwc", "counter")]
    cases += [(seed, "mwc", 0) for seed in SEED_TAIL_SEEDS]
    for seed, rng, slack in cases:
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, seed=seed, rng=rng)
        for blocked in (False, True):
            for tm in (1, SHARDS):
                want = ptk.init_pt_state_host(cfg, "cpu", blocked, tm)[:2]
                rp, pix_np, _ = ptk.ray_layout(WIDTH, HEIGHT, blocked, tm)
                if tm == 1 and slack == sk.SLACK:
                    got = ptk.init_pt_state(cfg, "cuda", blocked)[:2]
                else:
                    per = rp // tm
                    parts = [sk.seed_lanes(rng, seed, n, device="cuda", slack=slack, **(
                        dict(pix=torch.from_numpy(pix_np[k * per:(k + 1) * per]).cuda())
                        if blocked else dict(lanes=per, lane_offset=k * per)))
                        for k in range(tm)]
                    got = [torch.cat([p[i] for p in parts]) for i in (0, 1)]
                for g, w in zip(got, want):
                    g = g.cpu()
                    diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
                    worst = max(worst, diff)
                    words += g.numel()
                    check(torch.equal(g, w), f"seed {seed} {rng} slack {slack} "
                          f"{'K2' if blocked else 'K1'} layout, tile_multiple {tm}: the kernel "
                          "differs from numpy")
    rp = ptk.ray_layout(WIDTH, HEIGHT)[0]
    for seed, slack in ((0, sk.SLACK), (125, sk.SLACK), (125, 0)):
        plain = sk.seed_lanes_reference("mwc", seed, n, rp, device="cuda", slack=slack)
        kern = sk.seed_lanes("mwc", seed, n, rp, device="cuda", slack=slack)
        check(all(bool(torch.equal(a, b)) for a, b in zip(plain, kern)),
              f"seed {seed}, slack {slack}: the plain version on the card differs from the kernel")
    # No host sync in a seeding: the lane tables are made (copied) first.
    synced = []
    for rng in ("mwc", "counter"):
        for blocked in (False, True):
            cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, seed=125, rng=rng)
            ptk.init_pt_state(cfg, "cuda", blocked)
            pix = ptk.lane_layout(WIDTH, HEIGHT, blocked, 1, "cuda").pix
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                ptk.init_pt_state(cfg, "cuda", blocked)
                sk.seed_lanes(rng, 125, n, rp, pix=pix, device="cuda", slack=0)
                synced.append(f"{rng} {'K2' if blocked else 'K1'}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  {words} words bitwise numpy's (max |diff| {worst}); the plain version on the card "
          f"bitwise the kernel (seeds 0, 125; 125 at slack 0); no host sync in seed_lanes or "
          f"init_pt_state ({', '.join(synced)})")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, seed=SEED)
    dev = torch.device("cuda")
    # The launches alone, queued behind a sleep: K1's layout (the one
    # pass); K2's (the pass into a flat scratch, and the gather); the tail
    # at slack 0 (seed 125's last draw); the counter keys.
    kernel_ms, kernel_all = queued_ms(
        lambda: sk._launch("mwc", SEED, n, rp, None, 0, dev, sk.SLACK))
    pix2 = ptk.lane_layout(WIDTH, HEIGHT, True, 1, "cuda").pix
    k2_ms, _ = queued_ms(
        lambda: sk._launch("mwc", SEED, n, pix2.shape[0], pix2, 0, dev, sk.SLACK))
    tail_ms, _ = queued_ms(lambda: sk._launch("mwc", 125, n, rp, None, 0, dev, 0))
    no_tail_ms, _ = queued_ms(lambda: sk._launch("mwc", 125, n, rp, None, 0, dev, sk.SLACK))
    counter_ms, _ = queued_ms(lambda: sk._launch("counter", SEED, n, rp, None, 0, dev, sk.SLACK))
    event_ms, event_all = median_ms(lambda: sk.seed_lanes("mwc", SEED, n, rp, device="cuda"))
    host = {}
    for blocked in (False, True):
        key = "K2" if blocked else "K1"
        host[key] = {"kernel_route_ms": host_ms(lambda: ptk.init_pt_state(cfg, "cuda", blocked))[0],
                     "numpy_route_ms": host_ms(
                         lambda: ptk.init_pt_state_host(cfg, "cuda", blocked))[0]}
    plain_ms, plain_all = median_ms(lambda: sk.seed_lanes_reference(
        "mwc", SEED, n, rp, device="cuda"), reps=3)
    nbytes = 8 * rp
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"  mwc at {rp} lanes, device time a seeding: K1's layout (one pass) {kernel_ms:.5f} ms "
          f"(reps {['%.5f' % t for t in kernel_all]}); K2's layout, the pass into a flat scratch "
          f"and the gather {k2_ms:.5f}; seed 125 at slack 0 (the tail) {tail_ms:.5f} against "
          f"{no_tail_ms:.5f} at slack {sk.SLACK}; "
          f"counter keys {counter_ms:.5f}")
    print(f"  the wrapper (CUDA events around one call, nothing read back) {event_ms:.5f} ms "
          f"(reps {['%.5f' % t for t in event_all]})")
    for key, v in host.items():
        print(f"  init_pt_state, {key} layout (host clock): seed kernel {v['kernel_route_ms']:.4f} "
              f"ms, numpy's route {v['numpy_route_ms']:.4f} ms "
              f"({v['numpy_route_ms'] / v['kernel_route_ms']:.2f}x)")
    print(f"  plain version on the card: {plain_ms:.3f} ms "
          f"(reps {['%.3f' % t for t in plain_all]})")
    print(f"  bound: {nbytes} B written -> {bound_ms:.5f} ms at 3.35 TB/s (by bytes), share "
          f"{bound_ms / kernel_ms:.2%}")
    return {
        "name": "Seed seed_lanes",
        "route": "cuda",
        "designed_in": designed_in("Seed"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/seed_kernel.cu",
        "replaces": "se195_raytracer_tpu/core/rng.py:63",
        "replaces_note": ("no pl.pallas_call: the JAX package draws the seeds with numpy on the "
                          "host (core/rng.py:63-72 and :94-107, laid out at "
                          "kernels/pt_kernel.py:897-906)"),
        "launches": MAIN_LAUNCHES[SCENE]["Seed"],
        "max_abs_err": worst,
        "words_compared": words,
        "ms": kernel_ms,
        "k2_flat_gather_ms": k2_ms,
        "tail_slack0_ms": tail_ms,
        "no_tail_ms": no_tail_ms,
        "event_ms": event_ms,
        "counter_ms": counter_ms,
        "no_host_sync": synced,
        "init_pt_state_host_ms": host,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def count_plain_radiance():
    """Install a counting wrapper around the plain ``radiance`` in every
    module that calls it (``driver.render``, ``kernels.pt_kernel``) and in
    ``models.smallpt``. Returns (calls dict, undo)."""
    from se195_raytracer_tpu_torch.driver import render as dr
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.models import smallpt as sp

    orig = sp.radiance
    calls = {"n": 0}

    def counted(*args, **kw):
        calls["n"] += 1
        return orig(*args, **kw)

    mods = (dr, ptk, sp)
    for m in mods:
        m.radiance = counted

    def undo():
        for m in mods:
            m.radiance = orig

    return calls, undo


def grad_leaves(scene, camera, names=("center", "radius", "emission", "color", "orig", "target")):
    """(leaves by name, scene, camera): fresh copies of the named tensors
    that require grad, in place in the scene and camera."""
    leaves = {k: getattr(scene if k in ("center", "radius", "emission", "color") else camera,
                         k).detach().clone().requires_grad_(True) for k in names}
    scene = dataclasses.replace(scene, **{k: v for k, v in leaves.items()
                                          if k in ("center", "radius", "emission", "color")})
    camera = dataclasses.replace(camera, **{k: v for k, v in leaves.items()
                                            if k in ("orig", "target")})
    return leaves, scene, camera


def contract(a, b, tag):
    """K1's contract against the plain version: >= 97% of components within
    isclose(2e-3), means within rtol 2e-3. Returns (max_abs_err, mismatch)."""
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    check(bool(torch.isfinite(a).all()), f"{tag}: not finite")
    mismatch = 1.0 - torch.isclose(a, b, rtol=CLOSE_RTOL, atol=CLOSE_ATOL).double().mean().item()
    err = (a - b).abs().max().item()
    print(f"  {tag}: max_abs_err {err:.6g}, mismatch {mismatch:.4%}, mean {a.mean().item():.6f} "
          f"vs plain {b.mean().item():.6f}")
    check(mismatch <= MAX_MISMATCH, f"{tag}: {mismatch:.3%} components differ")
    check(abs(a.mean().item() - b.mean().item()) <= MEAN_RTOL * abs(b.mean().item()),
          f"{tag}: means differ")
    return err, mismatch


def compare_grads(ga, gb, tag):
    """Each leaf's gradient: finite, bitwise or within GRAD_RTOL. Returns
    (bitwise, max |diff| / max |gradient| over the leaves)."""
    import torch

    bitwise, rel = True, 0.0
    for k in ga:
        a, b = ga[k], gb[k]
        check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{tag} {k}: not finite")
        scale = b.abs().max().item()
        bitwise = bitwise and bool(torch.equal(a, b))
        rel = max(rel, (a - b).abs().max().item() / (scale or 1.0))
        check(bool(torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale)),
              f"{tag} {k}: gradients differ by {(a - b).abs().max().item():.3g} (scale {scale:.3g})")
    print(f"  {tag}: bitwise {bitwise}, max |diff| / max |grad| {rel:.3g}")
    return bitwise, rel


def compare_k1b(ga, gb, tag):
    """Each leaf's gradient through K1b against the plain path's: finite, and
    each row within ``GRAD_ROW_REL`` of its own largest plain gradient
    (``grad_row_error``). Returns (the worst row's error, max absolute
    difference) over the leaves."""
    import torch

    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import GRAD_ROW_REL, grad_row_error

    rows = grad_row_error(ga, gb)
    abs_err = 0.0
    for k in ga:
        check(bool(torch.isfinite(ga[k]).all()), f"{tag} {k}: not finite")
        abs_err = max(abs_err, (ga[k] - gb[k]).abs().max().item())
        check(rows[k] <= GRAD_ROW_REL, f"{tag} {k}: a row's max |diff| is {rows[k]:.3g} of its "
                                       f"largest gradient (> {GRAD_ROW_REL})")
    rel = max(rows.values())
    print(f"  {tag}: worst row max |diff| / max |grad| {rel:.3g} (bar {GRAD_ROW_REL}; "
          + ", ".join(f"{k} {v:.3g}" for k, v in rows.items()) + f"), max |diff| {abs_err:.3g}")
    return rel, abs_err


def plain_basis(camera, cfg):
    """``update_camera``'s basis of ``camera``, detached: K1b's camera input."""
    from se195_raytracer_tpu_torch.core.types import CameraBasis, update_camera

    b = update_camera(camera, cfg.width, cfg.height)
    return CameraBasis(b.orig.detach(), b.dir.detach(), b.x.detach(), b.y.detach())


def k1b_primal(scene, camera, cfg, cot, tag):
    """K1b's replayed primal against ``_render_plain_diff`` under no_grad,
    and K1b run twice on one cotangent: both must be bitwise (the kernel
    sums in a fixed order, without atomics). Returns (primal bitwise,
    repeat bitwise)."""
    import torch

    from se195_raytracer_tpu_torch.driver.optimize import _render_plain_diff
    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import pt_backward_cuda

    basis = plain_basis(camera, cfg)
    with torch.no_grad():
        prim = _render_plain_diff(scene, camera, cfg).reshape(-1, 3)
    flat, img = pt_backward_cuda(scene, basis, cfg, cot, image=True)
    repeat = bool(torch.equal(flat, pt_backward_cuda(scene, basis, cfg, cot)))
    same = bool(torch.equal(img, prim))
    lanes = int((img != prim).any(dim=1).sum())
    print(f"  {tag}: K1b's replayed primal bitwise the plain primal {same} ({lanes} lanes "
          f"differ); K1b twice on one cotangent bitwise {repeat}")
    check(same, f"{tag}: K1b's replayed primal differs from the plain path's on {lanes} lanes")
    check(repeat, f"{tag}: K1b run twice on one cotangent is not bitwise")
    return same, repeat


def k1b_against_plain(scene, camera, cfg, cot, tag):
    """K1b against its plain version (``pt_backward_reference``) on one
    cotangent: the primal bitwise, each field's rows within ``GRAD_ROW_REL``."""
    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import (
        pt_backward_cuda,
        pt_backward_reference,
        unpack_grad,
    )

    same, repeat = k1b_primal(scene, camera, cfg, cot, tag)
    basis = plain_basis(camera, cfg)
    n = scene.num_spheres
    a = unpack_grad(pt_backward_cuda(scene, basis, cfg, cot), n)
    b = unpack_grad(pt_backward_reference(scene, basis, cfg, cot), n)
    rel, abs_err = compare_k1b(a, b, f"{tag} K1b against pt_backward_reference")
    return {"primal_bitwise": same, "repeat_bitwise": repeat, "grad_max_rel_diff": rel,
            "grad_max_abs_diff": abs_err}


def grad_step_fn(scene0, camera0, cfg, target, remat=True, kernel=True):
    """A forward+backward step of the L2 loss over every leaf: through
    ``render_differentiable`` (kernel forward when ``kernel`` and the hard
    estimator) or the plain path with ``remat``."""
    import torch

    from se195_raytracer_tpu_torch.driver.optimize import _render_plain_diff, render_differentiable

    leaves, scene, camera = grad_leaves(scene0, camera0)

    def forward():
        if kernel:
            return render_differentiable(scene, camera, cfg)
        return _render_plain_diff(scene, camera, cfg, remat=remat)

    def step():
        for t in leaves.values():
            t.grad = None
        torch.mean((forward() - target) ** 2).backward()

    return step, forward, leaves, scene, camera


def grad_timing(scene, camera, cfg, target, label, profiled):
    """Forward+backward ms per step (median of 3 when ``profiled``, else of
    2), its split and the step's peak memory, on the host clock
    (synchronised); when ``profiled``, the card's idle share over a step.
    The hard step splits as the forward (K1 and its host setup), K1b alone
    (CUDA events, on the step's cotangent) and the rest on the host, and
    the plain route's step (the plain path both ways) is timed beside it."""
    import torch

    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import pt_backward_cuda
    from se195_raytracer_tpu_torch.kernels.pt_kernel import pt_multi_pass

    hard = cfg.soft_edges == 0.0
    step, forward, leaves, s, c = grad_step_fn(scene, camera, cfg, target)
    reps = 3 if profiled else 2
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_all = host_ms(step, reps=reps)
    peak = torch.cuda.max_memory_allocated()
    fwd_ms, _ = host_ms(forward, reps=reps)
    out = {"step_ms": step_ms, "step_reps_ms": step_all, "forward_ms": fwd_ms,
           "peak_mem_bytes": peak}
    if hard:
        # K1 alone on the forward's inputs, and K1b alone on the step's
        # cotangent (the L2's, 2 (img - target) / numel), by CUDA events.
        tab, cam, (s0, s1, acc), _, kw = pass_inputs(SCENE, cfg.width, cfg.height, "pt", "mwc",
                                                     "cuda", seed=cfg.seed)
        out["k1_ms"], _ = median_ms(lambda: pt_multi_pass(tab, cam, 0, s0, s1, acc,
                                                          num_samples=cfg.spp, **kw), reps=reps)
        with torch.no_grad():
            img = forward()
            cot = 2.0 * (img - target) / img.numel()
        basis = plain_basis(c, cfg)
        out["k1b_ms"], out["k1b_reps_ms"] = median_ms(
            lambda: pt_backward_cuda(scene, basis, cfg, cot), reps=max(reps, 5))
        out["host_rest_ms"] = step_ms - fwd_ms - out["k1b_ms"]
        plain_step = grad_step_fn(scene, camera, cfg, target, kernel=False)[0]
        torch.cuda.reset_peak_memory_stats()
        out["plain_route_step_ms"], out["plain_route_step_reps_ms"] = host_ms(plain_step,
                                                                             reps=reps)
        out["plain_route_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        split = (f"forward (K1 and its host setup) {fwd_ms:.3f} ms, K1 alone "
                 f"{out['k1_ms']:.4f} ms; K1b {out['k1b_ms']:.4f} ms (reps "
                 f"{['%.4f' % t for t in out['k1b_reps_ms']]}); the rest on the host "
                 f"{out['host_rest_ms']:.3f}; the plain route's step "
                 f"{out['plain_route_step_ms']:.3f} ms, peak memory "
                 f"{out['plain_route_peak_mem_bytes']} B")
    else:
        out["backward_ms"] = step_ms - fwd_ms
        split = (f"forward (plain, relaxed, checkpointed) {fwd_ms:.3f} ms; backward (recompute "
                 f"+ VJP) {out['backward_ms']:.3f}")
    idle = ""
    if profiled:
        # The card's busy time per step from the profiler, against the
        # step's time without it (the profiler's host overhead on thousands
        # of small ops would otherwise count as idle); the share under the
        # profiler beside it. Device activity only: a host trace of ~25k
        # operators takes seconds to gather.
        for _ in range(3):  # a session that caught no device event is made again
            wall, busy, _ = device_profile(step, reps=1, host=False)
            if busy > 0.0:
                break
        check(busy > 0.0, f"{label}: the profiler caught no device event")
        out["busy_ms"] = busy
        out["idle_share"] = max(0.0, 1 - busy / step_ms)
        out["idle_share_profiled"] = max(0.0, 1 - busy / wall)
        idle = (f"; card busy {busy:.3f} ms, idle share {out['idle_share']:.2%} "
                f"({out['idle_share_profiled']:.2%} of the profiled wall {wall:.3f} ms)")
    print(f"  {label}: step {step_ms:.3f} ms (reps {['%.3f' % t for t in step_all]}); {split}"
          f"{idle}; peak memory {peak} B")
    return out


def k1b_work(scene, camera, cfg):
    """What K1b's replay and reverse sweep must do on ``cfg``'s lanes,
    counted by the plain version of K1 over the same lanes and seeds (a
    ``radiance`` hook): rays, nearest sweeps, recorded bounces (sweeps that
    hit), shadow rays (light samples on the right half with wi > 0) and
    those that passed."""
    import torch

    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes
    from se195_raytracer_tpu_torch.ops.intersect import intersect_any, intersect_nearest

    n = cfg.width * cfg.height
    work = dict(rays=n * cfg.spp, sweeps=0, bounces=0, shadow_rays=0, lit=0)

    def hook(o, d, mask, max_t):
        o, d = o[mask], d[mask]
        if max_t is None:
            work["sweeps"] += int(mask.sum())
            work["bounces"] += int(intersect_nearest(scene, o, d)[2].sum())
        else:
            work["shadow_rays"] += int(mask.sum())
            work["lit"] += int((~intersect_any(scene, o, d, max_t[mask])).sum())

    s0, s1 = seed_lanes(cfg.rng, cfg.seed, n, n, device="cuda")
    acc = torch.zeros((3, n), dtype=torch.float32, device="cuda")
    with torch.no_grad():
        ptk.pt_pass_reference(
            ptk.pack_scene(scene), ptk.pack_camera(ptk.update_camera(camera, cfg.width,
                                                                     cfg.height)),
            0, s0, s1, acc, num_samples=cfg.spp, width=cfg.width, height=cfg.height,
            max_depth=cfg.max_depth, direct_only=cfg.integrator == "dl",
            light_indices=scene.light_indices, rng=cfg.rng, on_sweep=hook)
    return work


def k1b_bound(scene, camera, cfg):
    """K1b's bound on ``cfg``'s lanes from this run's work (``k1b_work``):
    the replay's ops at the FP32 rate without FMAs, the reverse sweep's at
    the FMA rate, against the bytes. Returns (bound ms, bound_by, replay
    ops, adjoint ops, work, bytes)."""
    work = k1b_work(scene, camera, cfg)
    n = scene.num_spheres
    replay = (OPS_CAMERA * work["rays"] + work["sweeps"] * (OPS_SPHERE_NEAREST * n + OPS_SHADE)
              + work["shadow_rays"] * OPS_SHADOW_SETUP + work["lit"] * OPS_SPHERE_SHADOW * n
              + (work["shadow_rays"] - work["lit"]) * OPS_SPHERE_SHADOW)
    adjoint = (work["bounces"] * OPS_ADJ_BOUNCE + work["lit"] * OPS_ADJ_LIGHT
               + work["rays"] * OPS_ADJ_CAMERA)
    nbytes = K1B_BYTES_PER_LANE * WIDTH * HEIGHT + 4 * (10 * n + 12) + 4 * 12 * n
    ops_ms = (replay / PEAK_FP32_OPS_NO_FMA + adjoint / PEAK_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", replay,
            adjoint, work, nbytes)


def k1b_entry(scene, camera, fwd, timing):
    """The kernels line's K1b entry: Cornell 512x512 spp 2, the main path's
    shape, and spp 8. ``ms`` is K1b alone on the hard step's cotangent (G6),
    the plain version's time is ``pt_backward_reference`` on the same
    inputs, the bounds count each run's work (``k1b_bound``), and each
    build's registers, stack frame and resident warps are read from the
    loaded library (``occupancy``)."""
    import numpy as np
    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import pt_backward_reference

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=GRAD_SPPS[0], seed=SEED)
    hard = timing[f"spp{GRAD_SPPS[0]} hard"]
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    basis = plain_basis(camera, cfg)
    plain_ms, plain_all = host_ms(lambda: pt_backward_reference(scene, basis, cfg, cot), reps=3)
    bound_ms, bound_by, replay, adjoint, work, nbytes = k1b_bound(scene, camera, cfg)
    ops = replay + adjoint
    ops_ms = (replay / PEAK_FP32_OPS_NO_FMA + adjoint / PEAK_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    k1b_ms = hard["k1b_ms"]
    cfg8 = dataclasses.replace(cfg, spp=GRAD_SPPS[-1])
    bound8_ms, _, replay8, adjoint8, work8, _ = k1b_bound(scene, camera, cfg8)
    ms8 = timing[f"spp{GRAD_SPPS[-1]} hard"]["k1b_ms"]
    # K1b twice on one cotangent, bitwise in every configuration (each a
    # check in k1b_primal).
    repeat = (all(v["k1b_repeat_bitwise"] for k, v in fwd.items() if k.startswith("spp"))
              and all(v["repeat_bitwise"] for v in fwd["k1b_variants"].values()))
    check(repeat, "K1b run twice on one cotangent is not bitwise")
    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import occupancy

    warps = occupancy(scene, cfg)["resident_warps_per_sm"]
    ptxas = [{"integrator": integ, "rng": rng,
              **occupancy(scene, dataclasses.replace(cfg, integrator=integ, rng=rng))}
             for integ in ("pt", "dl") for rng in ("mwc", "counter")]
    print(f"  K1b at {WIDTH}x{HEIGHT} spp {cfg.spp}: {k1b_ms:.4f} ms; plain version "
          f"(pt_backward_reference) {plain_ms:.3f} ms (reps {['%.3f' % t for t in plain_all]}); "
          f"work {work}; {ops:.6g} FP32 ops ({replay:.6g} replay, {adjoint:.6g} adjoint) -> "
          f"{ops_ms:.5f} ms (the replay at 33.5 T op/s, no FMA; the adjoint at 67 TFLOP/s); "
          f"{nbytes} B -> {bytes_ms:.5f} ms; bound {bound_ms:.5f} ms by {bound_by}, "
          f"share {bound_ms / k1b_ms:.2%}")
    print(f"  K1b at spp {cfg8.spp}: {ms8:.4f} ms, {ms8 / k1b_ms:.3f}x spp {cfg.spp}'s; work "
          f"{work8}; bound {bound8_ms:.5f} ms, share {bound8_ms / ms8:.2%}; ptxas {ptxas}; "
          f"{warps} warps resident an SM")
    return {
        "name": "K1b pt_backward_cuda",
        "route": "cuda",
        "designed_in": designed_in("K1b"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/pt_backward_kernel.cu",
        "replaces": ("se195_raytracer_tpu/driver/optimize.py:86-126 (jax.vjp of _render_jnp_diff, "
                     "the backward of the pallas_call at se195_raytracer_tpu/kernels/"
                     "pt_kernel.py:736; no Pallas backward)"),
        "launches": fwd[f"spp{GRAD_SPPS[0]}"]["launches_in_backward"]["K1b"],
        "launches_per_differentiable_step": {
            k: v["launches_in_backward"]["K1b"] for k, v in fwd.items() if k.startswith("spp")},
        "lane_column_launches_per_differentiable_step": {
            k: v["k1b_lane_column_launches"] for k, v in fwd.items() if k.startswith("spp")},
        "max_abs_err": max(v["k1b_grad_max_abs_diff"] for k, v in fwd.items()
                           if k.startswith("spp")),
        "max_rel_err": max(v["k1b_grad_max_rel_diff"] for k, v in fwd.items()
                           if k.startswith("spp")),
        "ms": k1b_ms,
        "ms_spp8": ms8,
        "spp8_over_spp2": ms8 / k1b_ms,
        "repeat_bitwise": repeat,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_rate": ("replay 33.5e12 FP32 op/s (no FMA: it rounds as the plain path), "
                       "reverse sweep 67e12 FP32 op/s (FMA)"),
        "bound_ops": {"replay": replay, "adjoint": adjoint},
        "work": work,
        "share_of_bound": bound_ms / k1b_ms,
        "bound_ms_spp8": bound8_ms,
        "share_of_bound_spp8": bound8_ms / ms8,
        "bound_ops_spp8": {"replay": replay8, "adjoint": adjoint8},
        "work_spp8": work8,
        "ptxas": ptxas,
        "resident_warps_per_sm": warps,
        "library_ms": None,
    }


def grad_section(card):
    """The grad phase: the differentiable path on the card. Returns the
    {"grad": ...} record and the launches per differentiable forward."""
    import numpy as np
    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver import grad_check as G
    from se195_raytracer_tpu_torch.driver.optimize import (
        OptState,
        _render_plain_diff,
        make_inverse_step,
        render_differentiable,
    )
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as pbk
    from se195_raytracer_tpu_torch.models import whitted5 as P
    from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene

    out = {"card": card}
    t0 = time.perf_counter()

    def since():
        return f"(+{time.perf_counter() - t0:.1f} s)"

    spec = get_spec(SCENE)
    scene0, cam0 = spec.to_scene(), spec.to_camera()
    start = G.grad_bench_start(scene0)
    calls, undo = count_plain_radiance()
    try:
        print(f"{since()} [G1] render_differentiable: {SCENE} {WIDTH}x{HEIGHT}, forward on K1, backward "
              "on K1b")
        fwd = {}
        for spp in GRAD_SPPS:
            cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=spp, seed=SEED)
            with torch.no_grad():
                target = render_differentiable(start, cam0, cfg)
            leaves, scene, camera = grad_leaves(scene0, cam0)
            zero_counters()
            calls["n"] = 0
            img = render_differentiable(scene, camera, cfg)
            torch.cuda.synchronize()
            launches, plain_calls = read_counters(), calls["n"]
            print(f"  spp {spp} forward: launches {launches}, plain radiance calls {plain_calls}")
            check(launches["K1"] == launches["Seed"] == 1
                  and not any(v for k, v in launches.items() if k not in ("K1", "Seed"))
                  and plain_calls == 0, f"spp {spp}: the forward must be one seeding, one K1 "
                  f"launch and no plain radiance, got {launches}, {plain_calls}")
            with torch.no_grad():
                primal = _render_plain_diff(scene, camera, cfg)
            err, mismatch = contract(img, primal, f"spp {spp} forward against the plain primal")
            cot = {}
            img.register_hook(lambda g: cot.setdefault("g", g))
            loss = torch.mean((img - target) ** 2)
            zero_counters()
            calls["n"] = 0
            ga = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            torch.cuda.synchronize()
            bwd_launches, bwd_calls = read_counters(), calls["n"]
            bwd_cols = pbk.pt_backward_cuda.lane_column_launches
            print(f"  spp {spp} backward: launches {bwd_launches}, plain radiance calls {bwd_calls}"
                  f"; K1b launches on the per-lane columns {bwd_cols}")
            check(bwd_cols == bwd_launches["K1b"], f"spp {spp}: {SCENE}'s K1b launches must take "
                  f"the per-lane columns, got {bwd_cols} of {bwd_launches['K1b']}")
            check(bwd_launches["Seed"] == bwd_launches["K1b"] == 1
                  and not any(v for k, v in bwd_launches.items() if k not in ("Seed", "K1b"))
                  and bwd_calls == 0,
                  f"spp {spp}: the backward must be one seeding and one K1b launch and run no "
                  f"plain radiance, got {bwd_launches}, {bwd_calls}")
            leaves_b, scene_b, camera_b = grad_leaves(scene0, cam0)
            plain = _render_plain_diff(scene_b, camera_b, cfg)
            gb = dict(zip(leaves_b, torch.autograd.grad(plain, list(leaves_b.values()),
                                                        cot["g"])))
            rel, abs_err = compare_k1b(ga, gb, f"spp {spp} K1b route against the plain VJP of "
                                                "the same cotangent")
            primal_ok, k1b_repeat = k1b_primal(scene0, cam0, cfg, cot["g"], f"spp {spp}")
            repeat = route = None
            if spp == GRAD_SPPS[0]:
                # Run to run on the card, and the whole plain route's L2
                # gradient (its forward image differs from K1's within K1's
                # contract, so its cotangent does too): reported, not held.
                again = dict(zip(leaves_b, torch.autograd.grad(
                    _render_plain_diff(scene_b, camera_b, cfg), list(leaves_b.values()),
                    cot["g"])))
                repeat = all(bool(torch.equal(again[k], gb[k])) for k in gb)
                lp = torch.mean((_render_plain_diff(scene_b, camera_b, cfg) - target) ** 2)
                gl = torch.autograd.grad(lp, list(leaves_b.values()))
                route = max((a - b).abs().max().item() / (b.abs().max().item() or 1.0)
                            for a, b in zip(ga.values(), gl))
                print(f"  spp {spp} plain VJP run twice: bitwise {repeat}; the plain route's L2 "
                      f"gradient against K1's route: max |diff| / max |grad| {route:.3g}")
            fwd[f"spp{spp}"] = {
                "k1_launches_per_forward": launches["K1"], "plain_radiance_in_forward": plain_calls,
                "plain_radiance_in_backward": bwd_calls, "launches_in_backward": bwd_launches,
                "k1b_lane_column_launches": bwd_cols,
                "forward_max_abs_err": err, "forward_mismatch": mismatch,
                "k1b_grad_max_rel_diff": rel, "k1b_grad_max_abs_diff": abs_err,
                "k1b_primal_bitwise": primal_ok, "k1b_repeat_bitwise": k1b_repeat,
                "plain_vjp_repeat_bitwise": repeat, "l2_route_max_rel_diff": route,
                "grad_max_abs": {k: v.abs().max().item() for k, v in ga.items()}}
        print(f"{since()} [G1b] K1b's replayed primal and gradient against the plain path, "
              f"{SCENE} {WIDTH}x{HEIGHT} spp 2: DL, and the counter RNG")
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=2, seed=SEED)
        cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
        variants = {}
        for integ, rng in (("dl", "mwc"), ("pt", "counter"), ("dl", "counter")):
            c = dataclasses.replace(cfg, integrator=integ, rng=rng)
            variants[f"{integ} {rng}"] = k1b_against_plain(scene0, cam0, c, cot,
                                                           f"{integ} {rng} spp 2")
        fwd["k1b_variants"] = variants
        print(f"{since()} [G1c] the soft route keeps the plain backward: spp 2, soft {GRAD_SOFT}")
        cfg_s = RenderConfig(width=WIDTH, height=HEIGHT, spp=2, seed=SEED, soft_edges=GRAD_SOFT)
        leaves, scene, camera = grad_leaves(scene0, cam0)
        zero_counters()
        calls["n"] = 0
        img = render_differentiable(scene, camera, cfg_s)
        ga = dict(zip(leaves, torch.autograd.grad(torch.sum(img * cot), list(leaves.values()))))
        torch.cuda.synchronize()
        soft_launches, soft_calls = read_counters(), calls["n"]
        check(soft_launches["K1b"] == 0 and soft_calls >= cfg_s.spp,
              f"soft: K1b {soft_launches['K1b']} launches, {soft_calls} plain radiance calls")
        leaves_b, scene_b, camera_b = grad_leaves(scene0, cam0)
        gb = dict(zip(leaves_b, torch.autograd.grad(_render_plain_diff(scene_b, camera_b, cfg_s),
                                                    list(leaves_b.values()), cot)))
        bitwise, rel = compare_grads(ga, gb, "soft route against the plain VJP")
        fwd["soft_route"] = {"plain_radiance_calls": soft_calls, "grad_bitwise": bitwise,
                             "grad_max_rel_diff": rel}
        print(f"{since()} [G1d] paths deeper than K1b's record keep the plain backward: "
              f"max_depth {GRAD_DEEP[0]}, {GRAD_DEEP[1]}x{GRAD_DEEP[1]} spp 1")
        cfg_d = RenderConfig(width=GRAD_DEEP[1], height=GRAD_DEEP[1], spp=1, seed=SEED,
                             max_depth=GRAD_DEEP[0])
        cot_d = cot[:GRAD_DEEP[1], :GRAD_DEEP[1]].contiguous()
        leaves, scene, camera = grad_leaves(scene0, cam0)
        img = render_differentiable(scene, camera, cfg_d)
        zero_counters()
        calls["n"] = 0
        ga = dict(zip(leaves, torch.autograd.grad(torch.sum(img * cot_d),
                                                  list(leaves.values()))))
        torch.cuda.synchronize()
        deep_launches, deep_calls = read_counters(), calls["n"]
        check(deep_launches["K1b"] == 0 and deep_calls == cfg_d.spp,
              f"max_depth {GRAD_DEEP[0]}: K1b {deep_launches['K1b']} launches, {deep_calls} "
              "plain radiance calls in the backward")
        leaves_b, scene_b, camera_b = grad_leaves(scene0, cam0)
        gb = dict(zip(leaves_b, torch.autograd.grad(_render_plain_diff(scene_b, camera_b, cfg_d),
                                                    list(leaves_b.values()), cot_d)))
        bitwise, rel = compare_grads(ga, gb, f"max_depth {GRAD_DEEP[0]} route against the "
                                             "plain VJP")
        fwd["deep_route"] = {"max_depth": GRAD_DEEP[0], "plain_radiance_calls": deep_calls,
                             "grad_bitwise": bitwise, "grad_max_rel_diff": rel}
        out["forward_backward"] = fwd

        print(f"{since()} [G2] counter RNG: the kernel forward and the plain recompute draw one stream")
        cfg_c = RenderConfig(width=WIDTH, height=HEIGHT, spp=2, seed=SEED, rng="counter")
        with torch.no_grad():
            img = render_differentiable(scene0, cam0, cfg_c)
            primal = _render_plain_diff(scene0, cam0, cfg_c)
        err, mismatch = contract(img, primal, "counter spp 2 forward against the plain primal")
        out["counter"] = {"max_abs_err": err, "mismatch": mismatch}

        w2, h2, spp2 = GRAD_K2
        print(f"{since()} [G3] K2 on the path: {COMPLEX} {w2}x{h2} spp {spp2}")
        cspec = get_spec(COMPLEX)
        cfg2 = RenderConfig(width=w2, height=h2, spp=spp2, seed=SEED)
        leaves, scene, camera = grad_leaves(cspec.to_scene(), cspec.to_camera(),
                                            ("center", "color"))
        zero_counters()
        calls["n"] = 0
        img = render_differentiable(scene, camera, cfg2)
        torch.cuda.synchronize()
        launches, plain_calls = read_counters(), calls["n"]
        check(launches["K2"] == launches["Seed"] == 1
              and not any(v for k, v in launches.items() if k not in ("K2", "Seed"))
              and plain_calls == 0, f"complex forward: {launches}, plain {plain_calls}")
        cot = {}
        img.register_hook(lambda g_: cot.setdefault("g", g_))
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        calls["n"] = 0
        g = torch.autograd.grad(torch.mean(img ** 2), list(leaves.values()))
        torch.cuda.synchronize()
        k2_bwd_ms = (time.perf_counter() - t) * 1e3
        k2_peak = torch.cuda.max_memory_allocated()
        bwd_launches, bwd_calls = read_counters(), calls["n"]
        finite = all(bool(torch.isfinite(x).all()) for x in g)
        nonzero = all(x.abs().max().item() > 0 for x in g)
        print(f"  forward launches {launches}, plain radiance calls {plain_calls}; backward "
              f"launches {bwd_launches}, plain radiance calls {bwd_calls}, {k2_bwd_ms:.1f} ms, "
              f"peak memory {k2_peak} B; centre and colour gradients finite {finite}, nonzero "
              f"{nonzero}")
        check(finite and nonzero, "complex gradients not finite or zero")
        check(bwd_launches["K1b"] == 0 and bwd_calls == spp2,
              f"complex backward: the plain recompute (K1b has no blocked sweep), got "
              f"{bwd_launches}, {bwd_calls} plain radiance calls")
        leaves_b, scene_b, camera_b = grad_leaves(cspec.to_scene(), cspec.to_camera(),
                                                  ("center", "color"))
        gb = torch.autograd.grad(_render_plain_diff(scene_b, camera_b, cfg2),
                                 list(leaves_b.values()), cot["g"])
        k2_bitwise, k2_rel = compare_grads(dict(zip(leaves, g)), dict(zip(leaves_b, gb)),
                                           "complex K2 route against the plain VJP")
        out["k2"] = {"k2_launches_per_forward": launches["K2"], "k1_launches": launches["K1"],
                     "backward_ms": k2_bwd_ms, "peak_mem_bytes": k2_peak,
                     "plain_radiance_in_backward": bwd_calls, "grad_bitwise": k2_bitwise,
                     "grad_max_rel_diff": k2_rel}
    finally:
        undo()

    print(f"{since()} [G4] pixel gradients against central finite differences: {SCENE} "
          f"{WIDTH}x{HEIGHT} spp 2 seed {SEED}")
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=2, seed=SEED)
    checks = []
    for label, param, idx, eps in G.PIXEL_CHECKS:
        for soft in (0.0, GRAD_SOFT):
            mx, p99, scale, jvp = G.pixel_grad_check(scene0, cam0, cfg, param, idx, eps, soft)
            pct = 100.0 * mx / scale
            limit = PIXEL_BOUND_PCT[(label, soft > 0.0)]
            print(f"  {label} {list(idx)} eps {eps} soft {soft}: max_abs_err {mx:.6g}, "
                  f"p99_abs_err {p99:.6g}, fd_scale {scale:.6g}, {pct:.4f}% of scale"
                  + ("" if limit is None else f" (bound {limit}%)"))
            check(bool(torch.isfinite(jvp).all()), f"{label} soft {soft}: JVP not finite")
            if limit is not None:
                check(pct <= limit, f"{label} soft {soft}: {pct:.3f}% of scale > {limit}%")
            checks.append({"param": label, "index": list(idx), "eps": eps, "soft_edges": soft,
                           "max_abs_err": mx, "p99_abs_err": p99, "fd_scale": scale,
                           "max_err_pct_of_scale": pct, "bound_pct": limit})
    out["pixel_grad_checks"] = checks

    print(f"{since()} [G5] inverse rendering, {GRAD_STEPS} steps each: {SCENE} {WIDTH}x{HEIGHT} spp 2, "
          "light moved (8, -5, 0), left wall tinted; center and color train")
    inverse = {}
    # The hard run twice: K1's forward and K1b's backward, then the plain
    # route (use_kernel=False: the plain path both ways) on the same target,
    # its trajectory printed beside K1b's.
    for mode in ("hard", "hard plain route", "soft"):
        cfg_m = RenderConfig(width=WIDTH, height=HEIGHT, spp=2, seed=SEED,
                             soft_edges=GRAD_SOFT if mode == "soft" else 0.0,
                             use_kernel=mode != "hard plain route")
        if mode != "hard plain route":
            with torch.no_grad():
                target = render_differentiable(scene0, cam0, cfg_m)
        mult = GRAD_GEOM_MULT[mode.split()[0]]
        step = make_inverse_step(
            target, cfg_m, lambda tr: G.GroupAdam(
                {"geom": ([tr["center"]], GRAD_LR * mult), "mat": ([tr["color"]], GRAD_LR)},
                GRAD_STEPS, GRAD_ALPHA),
            lambda n: n in ("center", "color"))
        st = OptState(start, cam0, None, None)
        losses, secs = [], []
        for _ in range(GRAD_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st = step(st)
            losses.append(float(st.loss))
            secs.append((time.perf_counter() - t) * 1e3)
        li = G.START_LIGHT
        err_c = (st.scene.center[li] - scene0.center[li]).abs().max().item()
        finite = all(math.isfinite(x) for x in losses)
        med = statistics.median(secs[1:])
        print(f"  {mode}: losses {['%.6g' % x for x in losses]}; median step {med:.3f} ms; light "
              f"centre error {err_c:.4f} after {GRAD_STEPS} steps (8 at the start)")
        check(finite and min(losses) < losses[0], f"{mode}: losses not finite or never below "
                                                  "the first")
        inverse[mode] = {"losses": losses, "step_ms": secs, "median_step_ms": med,
                         "light_center_err": err_c}
    print("  hard, K1b route against the plain route, loss by step: " + "; ".join(
        f"{a:.6g} / {b:.6g}" for a, b in zip(inverse["hard"]["losses"],
                                             inverse["hard plain route"]["losses"])))
    out["inverse"] = inverse

    print(f"{since()} [G6] forward+backward per step, {SCENE} {WIDTH}x{HEIGHT} ({card})")
    timing = {}
    for spp in GRAD_SPPS:
        for soft in (0.0, GRAD_SOFT):
            cfg_t = RenderConfig(width=WIDTH, height=HEIGHT, spp=spp, seed=SEED, soft_edges=soft)
            with torch.no_grad():
                target = render_differentiable(start, cam0, dataclasses.replace(cfg_t,
                                                                                soft_edges=0.0))
            key = f"spp{spp} {'hard' if soft == 0.0 else f'soft {soft}'}"
            timing[key] = grad_timing(scene0, cam0, cfg_t, target, key,
                                      profiled=spp == GRAD_SPPS[0])
    cfg_m = RenderConfig(width=WIDTH, height=HEIGHT, spp=2, seed=SEED)
    with torch.no_grad():
        target = render_differentiable(start, cam0, cfg_m)
    memory = {}
    for remat in (True, False):
        step = grad_step_fn(scene0, cam0, cfg_m, target, remat=remat, kernel=False)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        memory[f"remat {'on' if remat else 'off'}"] = {
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "step_ms": ms}
        torch.cuda.empty_cache()
    print(f"  plain-route step, spp 2, peak memory: remat on "
          f"{memory['remat on']['peak_mem_bytes']} B ({memory['remat on']['step_ms']:.3f} ms), "
          f"off {memory['remat off']['peak_mem_bytes']} B ({memory['remat off']['step_ms']:.3f} ms)")
    out["timing"] = timing
    out["remat_memory"] = memory
    out["k1b_kernel"] = k1b_entry(scene0, cam0, fwd, timing)

    w5 = W5_GRAD
    print(f"{since()} [G7] whitted5 soft: room5 {w5['width']}x{w5['height']} spp {w5['spp']}, soft "
          f"{w5['soft']}, plain tracer; d(L2)/d box_pos[{w5['light']}, 0]")
    scene5 = room5_scene(device="cuda")
    kw5 = dict(width=w5["width"], height=w5["height"], spp=w5["spp"], soft_edges=w5["soft"],
               use_kernel=False)
    with torch.no_grad():
        target5 = P.render_whitted5(scene5, **kw5)
    box_pos = scene5.box_pos.detach().clone()
    box_pos[w5["light"], 0] += 1.5
    box_pos.requires_grad_(True)
    moved = dataclasses.replace(scene5, box_pos=box_pos)

    def w5_step():
        box_pos.grad = None
        torch.mean((P.render_whitted5(moved, **kw5) - target5) ** 2).backward()

    torch.cuda.reset_peak_memory_stats()
    w5_ms, w5_all = host_ms(w5_step, reps=2)
    w5_peak = torch.cuda.max_memory_allocated()
    g5 = box_pos.grad[w5["light"], 0].item()
    print(f"  gradient {g5:.6g} (JAX's test expects > 0); step {w5_ms:.3f} ms "
          f"(reps {['%.3f' % t for t in w5_all]}); peak memory {w5_peak} B")
    check(math.isfinite(g5) and g5 > 0.0, f"whitted5 soft light-position gradient {g5}")
    out["whitted5_soft"] = {"grad": g5, "step_ms": w5_ms, "peak_mem_bytes": w5_peak}
    return out


def k2_section():
    """Phases 5-6: K2 parity and cull on/off, the complex783 main path, K2
    timing and its culled-work bound."""
    import torch

    from se195_raytracer_tpu_torch.driver.render import render
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    print(f"[5] K2 against pt_pass_reference on the card: {COMPLEX} {WIDTH}x{HEIGHT}, 1 spp")
    errs = [compare_pass(COMPLEX, WIDTH, HEIGHT, "pt", rng, "cuda") for rng in ("mwc", "counter")]
    check_resume(COMPLEX, WIDTH, HEIGHT, "cuda")
    scene_tab, cam_tab, (s0, s1, acc), pix, kw = pass_inputs(
        COMPLEX, WIDTH, HEIGHT, "pt", "mwc", "cuda")
    on = ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=1, cull=True, **kw)
    off = ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=1, cull=False, **kw)
    same = all(bool(torch.equal(a, b)) for a, b in zip(on, off))
    print(f"  cull on vs off, 1 spp: acc, s0, s1 bitwise equal: {same}")
    check(same, "K2 with the cull differs from K2 without it")

    print(f"[6] main path: {COMPLEX} {WIDTH}x{HEIGHT} spp={SPP}")
    with tempfile.TemporaryDirectory() as tmp:
        img, cfg, launches = run_main_path(
            COMPLEX, WIDTH, HEIGHT, SPP, os.path.join(tmp, "complex.png"), "K2")
    torch.cuda.synchronize()
    print(f"  launches during the main path: {launches}")
    same_as_numpy_seeds(img, COMPLEX, cfg)
    hook, work = ptk.culled_work_counter(scene_tab)
    t = time.perf_counter()
    _, _, pacc = ptk.pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, pix,
                                       num_samples=SPP, on_sweep=hook, **kw)
    torch.cuda.synchronize()
    print(f"  plain version with the work count: {time.perf_counter() - t:.2f} s; work {work}")
    plain_mean = pacc.mean().item()  # no pad lanes at 512x512
    kernel_mean = img.mean().item()
    print(f"  image mean {kernel_mean:.6f} vs plain {plain_mean:.6f}")
    check(abs(kernel_mean - plain_mean) <= MAIN_MEAN_RTOL * abs(plain_mean),
          "complex 8-spp image mean differs from the plain version by more than 1%")

    print("  K2 timing")
    spec = get_spec(COMPLEX)
    scene, camera = spec.to_scene(), spec.to_camera()
    kernel_ms, kernel_all = median_ms(lambda: ptk.pt_blocked_pass(
        scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=SPP, **kw), reps=5)
    nocull_ms, nocull_all = median_ms(lambda: ptk.pt_blocked_pass(
        scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=SPP, cull=False, **kw), reps=3)
    plain_ms, plain_all = median_ms(lambda: ptk.pt_pass_reference(
        scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=SPP, **kw), reps=2)
    torch.cuda.reset_peak_memory_stats()
    e2e_ms, e2e = host_ms(lambda: render(scene, camera, cfg)[0].cpu(), reps=5)
    peak_mem = torch.cuda.max_memory_allocated()
    e2e_pair = paired_e2e(lambda: render(scene, camera, cfg)[0].cpu(), "complex783")
    parts, replaced = render_breakdown(scene.to("cuda"), camera.to("cuda"), cfg, kernel_ms,
                                       e2e_ms, "complex783")
    rays = WIDTH * HEIGHT * SPP
    ops = (OPS_CAMERA * rays + OPS_SHADE * work["nearest_rays"]
           + OPS_SHADOW_SETUP * work["shadow_rays"]
           + OPS_SPHERE_NEAREST * work["nearest_tests"]
           + OPS_SPHERE_SHADOW * work["shadow_tests"] + OPS_BOUND * work["bound_tests"])
    nb = scene.num_spheres // ptk.SPHERE_BLOCK
    full = (scene.num_spheres * (work["nearest_rays"] + work["shadow_rays"]))
    print(f"  K2 kernel (cull on): {kernel_ms:.4f} ms per {SPP}-spp call "
          f"(reps {['%.4f' % t for t in kernel_all]}), {rays / kernel_ms * 1e3:.4g} rays/s")
    print(f"  K2 kernel (cull off): {nocull_ms:.4f} ms (reps {['%.4f' % t for t in nocull_all]})")
    print(f"  end to end incl. readback: {e2e_ms:.4f} ms (reps {['%.3f' % t for t in e2e]}), "
          f"{rays / e2e_ms * 1e3:.4g} rays/s")
    print(f"  plain version: {plain_ms:.3f} ms (reps {['%.3f' % t for t in plain_all]})")
    print(f"  peak memory allocated: {peak_mem} B")
    print(f"  culled sweep: {work['nearest_tests'] + work['shadow_tests']} sphere tests of "
          f"{full} unculled ({(work['nearest_tests'] + work['shadow_tests']) / full:.2%}), "
          f"{work['bound_tests']} bound tests, nb {nb}")
    own = work["kernel_nearest_tests"] + work["kernel_shadow_tests"]
    print(f"  K2's own sweep, per ray: {own} sphere tests ({own / full:.2%} of unculled), "
          f"{work['kernel_bound_tests']} block and half-block bound tests, "
          f"{work['kernel_group_tests']} group and remainder bound tests")
    bound_ms, bound_by = bound(ops, STATE_BYTES_PER_LANE * s0.shape[0], kernel_ms, "K2")
    split = k2_split(WIDTH, HEIGHT, SPP, {(7, "pt"): work})
    return {
        "name": "K2 pt_blocked_pass",
        "route": "cuda",
        "designed_in": designed_in("K2"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/pt_kernel.cu",
        "replaces": "se195_raytracer_tpu/kernels/pt_kernel.py:366",
        "launches": launches["K2"],
        "max_abs_err": max(e[0] for e in errs),
        "mismatch_frac": max(e[1] for e in errs),
        "state_mismatch_frac": max(e[2] for e in errs),
        "cull_bitwise": same,
        "ms": kernel_ms,
        "nocull_ms": nocull_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "e2e_ms": e2e_ms,
        "e2e_rays_per_s": rays / e2e_ms * 1e3,
        "kernel_rays_per_s": rays / kernel_ms * 1e3,
        "peak_mem_bytes": peak_mem,
        "breakdown_ms": parts,
        "replaced_steps_ms": replaced,
        "e2e_in_turns": e2e_pair,
        "work": work,
        "split": split,
    }


def k3_section():
    """Phases 7-8: K3 against the plain tracer, the Whitted main path, K3
    timing."""
    import torch

    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.models import whitted as W
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    w, h, ss, depth = WHITTED["width"], WHITTED["height"], WHITTED["supersample"], WHITTED["trace_depth"]
    print(f"[7] K3 against the plain tracer: {w}x{h}, {ss}x{ss}, depth {depth}")
    max_err, max_bad, works = 0.0, 0.0, {}
    plain_tile = 1 << 20  # rays per chunk of the plain tracer
    for name in ("room", "grid"):
        scene = WHITTED_SCENES[name]("cuda")
        o, d = W.whitted_camera_rays_device(w, h, ss, device="cuda")
        tiles = wk.rays_to_tiles(o, d)
        for bias in (0.0, 0.005):
            work = {}
            plain = W.render_whitted_scene(scene, w, h, ss, depth, bias, ray_tile=plain_tile,
                                           work=work)
            works[(name, bias)] = work
            frame = wk.whitted_frame_cuda(scene, width=w, height=h, supersample=ss,
                                          trace_depth=depth, hit_bias=bias)
            acc = wk.whitted_trace_cuda(scene, tiles, trace_depth=depth, hit_bias=bias)
            via_rays = wk.tiles_to_frame(acc, w, h, ss)
            for entry, img in (("frame", frame), ("rays", via_rays)):
                err = (img - plain).abs().max().item()
                bad = (~torch.isclose(img, plain, rtol=W_RTOL, atol=W_ATOL)).sum().item()
                print(f"  {name} hit_bias {bias} {entry} entry: max_abs_err {err:.6g}, "
                      f"{bad} components outside (rtol {W_RTOL}, atol {W_ATOL}), "
                      f"mean {img.mean().item():.6f} vs plain {plain.mean().item():.6f}")
                check(bool(torch.isfinite(img).all()), f"K3 {name} {entry}: not finite")
                check(bad == 0, f"K3 {name} hit_bias {bias} {entry} entry: {bad} components differ")
                max_err = max(max_err, err)
                max_bad = max(max_bad, bad / img.numel())
            print(f"    live work (plain): {work}")

    print(f"[8] main path: whitted room {w}x{h} {ss}x{ss}")
    cfg = RenderConfig(width=w, height=h, supersample=ss, trace_depth=depth)
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "room.png")
        zero_counters()
        rc = cli.main(["render", "--integrator", "whitted", "--scene", "room", "--width", str(w),
                       "--height", str(h), "--supersample", str(ss), "--trace-depth", str(depth),
                       "--out", out_png])
        after_cli = read_counters()
        img = W.render_whitted(WHITTED_SCENES["room"](), cfg)
        launches = read_counters()
        check(rc == 0, f"cli render exited {rc}")
        with open(out_png, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "cli output is not a PNG")
    print(f"  launches during the main path: {launches}")
    others = {k: v for k, v in launches.items() if k != "K3"}
    check(after_cli["K3"] == 1 and launches["K3"] == 2 and not any(others.values()),
          f"launches: cli {after_cli}, total {launches} (want one K3 per call, nothing else)")
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(img).all()), "whitted image")
    check(img.max().item() > 1.0, "whitted image is black")

    print("  K3 timing (room, hit_bias 0)")
    scene = WHITTED_SCENES["room"]("cuda")
    kernel_ms, kernel_all = median_ms(lambda: wk.whitted_frame_cuda(
        scene, width=w, height=h, supersample=ss, trace_depth=depth))
    plain_ms, plain_all = median_ms(lambda: W.render_whitted_scene(
        scene, w, h, ss, depth, ray_tile=plain_tile), reps=2)
    torch.cuda.reset_peak_memory_stats()
    e2e_ms, e2e = host_ms(lambda: W.render_whitted(scene, cfg).cpu())
    peak_mem = torch.cuda.max_memory_allocated()
    work = works[("room", 0.0)]
    planes = sum(1 for t in scene.ptype if t == 0)
    spheres = scene.num_prims - planes
    sphere_lights = sum(1 for i in scene.light_indices if scene.ptype[i] != 0)
    ops = (work["nodes"] * (W_OPS_NODE + planes * W_OPS_PLANE + spheres * W_OPS_SPHERE)
           + work["hit_nodes"] * len(scene.light_indices) * W_OPS_LIGHT
           + work["shadow_tests"] * min(W_OPS_PLANE, W_OPS_SPHERE))
    rays = w * h * ss * ss
    print(f"  K3 kernel (frame entry): {kernel_ms:.4f} ms (reps {['%.4f' % t for t in kernel_all]}), "
          f"{rays / kernel_ms * 1e3:.4g} rays/s")
    print(f"  end to end incl. readback: {e2e_ms:.4f} ms (reps {['%.3f' % t for t in e2e]})")
    print(f"  plain version: {plain_ms:.3f} ms (reps {['%.3f' % t for t in plain_all]})")
    print(f"  peak memory allocated: {peak_mem} B")
    print(f"  live nodes {work['nodes']} ({work['nodes'] / rays:.3f} per ray), lit nodes "
          f"{work['hit_nodes']}, shadow tests {work['shadow_tests']}; {planes} planes, "
          f"{spheres} spheres, {sphere_lights} sphere lights")
    bound_ms, bound_by = bound(ops, h * w * 3 * 4, kernel_ms, "K3")
    split = k3_split(scene, w, h, {(depth, ss): work})
    return {
        "name": "K3 whitted_frame_cuda / whitted_trace_cuda",
        "route": "cuda",
        "designed_in": designed_in("K3"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/whitted_kernel.cu",
        "replaces": "se195_raytracer_tpu/kernels/whitted_kernel.py:121",
        "launches": launches["K3"],
        "max_abs_err": max_err,
        "mismatch_frac": max_bad,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "e2e_ms": e2e_ms,
        "kernel_rays_per_s": rays / kernel_ms * 1e3,
        "peak_mem_bytes": peak_mem,
        "work": work,
        "split": split,
    }


def psnr(a, b):
    """PSNR of ``a`` against the reference ``b``, peak = max of ``b``
    (tools/adaptive_ab.py's definition)."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    peak = float(b.max()) or 1.0
    return 10.0 * math.log10(peak * peak / max(mse, 1e-20))


def uv_lanes(n, seed, device):
    """Random texture coordinates, 1% of them far negative (u + 1000.5 < 0:
    the floor modulo must keep them inside the texture)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    far = rng.random(n) < 0.01
    u[far] = rng.uniform(-5000.0, -1001.0, far.sum()).astype(np.float32)
    v[far[::-1]] = rng.uniform(-5000.0, -1001.0, far.sum()).astype(np.float32)
    tex = rng.integers(0, 2, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (tex, u, v))


def write_u8_textures(tmp, size=200):
    """The reference's two room5 assets' stand-ins: random u8 TGA files of
    ``size`` x ``size`` in ``tmp`` (io/tga.py reads them as k/256)."""
    import numpy as np

    from se195_raytracer_tpu_torch.io.tga import write_tga

    rng = np.random.default_rng(0)
    for name in ("checker", "marble"):
        write_tga(os.path.join(tmp, f"{name}.tga"),
                  rng.integers(0, 256, size=(size, size, 3)).astype(np.uint8))


def k4_texel_stream(scene, width, height):
    """(tex, u, v): every texel fetch of the plain tracer at ``width`` x
    ``height``, spp 1, seed W5_SEED, node-major and in ray order within a
    node, as K4 meets them."""
    import torch

    from se195_raytracer_tpu_torch.models import whitted5 as P

    o, d = P._cached_rays5(width, height, (0.5, 0.5), "cuda")
    lanes = []
    P.trace_passes(scene, o, d, P._state5(width * height, W5_SEED, "cuda"),
                   on_texel=lambda t, u, v: lanes.append((t, u, v)))
    return tuple(torch.cat(x) for x in zip(*lanes))


def k5_bytes(n, flat, textab):
    """K5's bytes for ``n`` lanes: 25 B a lane and the [texels, 3] float32
    atlas and its table read once (the yardstick of every layout)."""
    return n * K5_BYTES_LANE + flat.numel() * 4 + textab.numel() * 4


def gather_blend(scene, tex, u, v):
    """The library yardstick of K5: torch's gather atlas[v, u] at the four
    corners and the blend, indices and weights made beforehand (plain
    torch; the textures of ``scene`` share one shape). Returns the call."""
    import torch

    atlas2 = torch.cat(list(scene.textures))
    th, tw = scene.textures[0].shape[:2]
    fu, fv = (u + 1000.5) * tw, (v + 1000.0) * tw
    u1 = (torch.floor(fu).to(torch.int32) % tw).long()
    v1 = (torch.floor(fv).to(torch.int32) % th + tex * th).long()
    u2, v2 = (u1 + 1) % tw, (v1 - tex * th + 1) % th + tex * th
    fx, fy = fu - torch.floor(fu), fv - torch.floor(fv)
    w = [((1 - fx) * (1 - fy))[:, None], (fx * (1 - fy))[:, None], ((1 - fx) * fy)[:, None],
         (fx * fy)[:, None]]
    return lambda: (atlas2[v1, u1] * w[0] + atlas2[v1, u2] * w[1]
                    + atlas2[v2, u1] * w[2] + atlas2[v2, u2] * w[3])


def k5_lane_sets(stream):
    """{label: (tex, u, v)}: K5_RANDOM's random lanes and K4's ``stream``."""
    sets = {label: uv_lanes(n, k + 1, "cuda") for k, (label, n) in enumerate(K5_RANDOM.items())}
    sets[K5_STREAM] = stream
    return sets


def k5_atlases(tmp):
    """{form: room5 scene}: the procedural textures (float form) and the
    u8/256 2 x 200 x 200 TGA files in ``tmp`` (u8 form)."""
    from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S

    return {"f32": S.room5_scene("procedural", device="cuda"),
            "u8": S.room5_scene("real", device="cuda", textures_dir=tmp)}


def k5_section(tmp):
    """Phase 9: K5 alone against _texel, bitwise, in both forms on three
    lane sets; device time (and back-to-back launch time), bounds, plain
    and torch gather."""
    import torch

    from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
    from se195_raytracer_tpu_torch.models import whitted5 as P

    write_u8_textures(tmp)
    atlases = k5_atlases(tmp)
    w, h = W5_SIZES[-1]
    stream = k4_texel_stream(atlases["f32"], w, h)
    sets = k5_lane_sets(stream)
    print(f"[9] K5 against _texel on the card: lane sets "
          f"{ {k: int(v[0].shape[0]) for k, v in sets.items()} } (the K4 stream: every fetch "
          f"of room5 {w}x{h} spp 1)")
    rows, bad_lanes, all_lanes, max_err = {}, 0, 0, 0.0
    for form, scene in atlases.items():
        layout = tk.pack_texel_units(scene.textures)
        forms = layout.table[:, 3].tolist()
        want = tk.TEX_U8 if form == "u8" else tk.TEX_F32
        check(forms == [want] * len(forms), f"K5 {form}: packed in forms {forms}")
        flat, textab = tk.pack_texel_atlas(scene.textures)
        th, tw = scene.textures[0].shape[:2]
        atlas = torch.cat(list(scene.textures))
        for label, (tex, u, v) in sets.items():
            live = torch.ones_like(u, dtype=torch.bool)
            out = tk.texel_fetch_cuda(flat, textab, tex, u, v, live, layout=layout)
            ref = P._texel(atlas, u, v, row_offset=tex * th, wrap_shape=(th, tw)).T
            diff = int((out != ref).any(dim=0).sum())
            err = (out - ref).abs().max().item()
            bad_lanes += diff
            all_lanes += u.shape[0]
            max_err = max(max_err, err)
            check(bool(torch.isfinite(out).all()), f"K5 {form} {label}: not finite")
            n = u.shape[0]

            def kernel():
                return tk.texel_fetch_cuda(flat, textab, tex, u, v, live, layout=layout)

            gather = gather_blend(scene, tex, u, v)
            kernel_ms = device_ms(kernel, "texel_fetch_kernel")
            plain_ms = device_ms(lambda: tk.texel_fetch_reference(flat, textab, tex, u, v, live))
            lib_ms = device_ms(gather)
            events_ms, kall = launch_ms(kernel)
            lib_events_ms, _ = median_ms(gather, reps=20)
            print(f"  K5 {form} {tuple(scene.textures[0].shape)} x {len(scene.textures)}, {label} "
                  f"({n} lanes): {diff} lanes differ from _texel (max_abs_err {err:.3g}); device "
                  f"time per call: kernel {kernel_ms:.5f} ms, plain {plain_ms:.4f} ms, torch "
                  f"gather + blend {lib_ms:.4f} ms; CUDA events: kernel {events_ms:.5f} ms per "
                  f"back-to-back launch (reps {min(kall):.5f}-{max(kall):.5f}), torch gather + "
                  f"blend {lib_events_ms:.4f} ms per call")
            bound_ms, bound_by = bound(n * K5_OPS_LANE, k5_bytes(n, flat, textab), kernel_ms,
                                       f"K5 {form} {label}")
            rows[f"{form} {label}"] = dict(lanes=n, ms=kernel_ms, plain_ms=plain_ms,
                                           library_ms=lib_ms, bound_ms=bound_ms,
                                           bound_by=bound_by, share=bound_ms / kernel_ms,
                                           events_ms=events_ms, library_events_ms=lib_events_ms,
                                           unit_bytes=layout.units.numel())
    check(bad_lanes == 0, f"K5: {bad_lanes} lanes differ from _texel")
    # The floor under the K4 stream: the same launch with every lane dead
    # (each reads its live flag, texture id and coordinates, and writes 0).
    tex, u, v = stream
    dead = torch.zeros_like(u, dtype=torch.bool)
    flat, textab = tk.pack_texel_atlas(atlases["u8"].textures)
    layout = tk.pack_texel_units(atlases["u8"].textures)
    floor_ms = device_ms(lambda: tk.texel_fetch_cuda(flat, textab, tex, u, v, dead, layout=layout),
                         "texel_fetch_kernel")
    print(f"  K5 on the K4 stream with every lane dead (no fetch): device time {floor_ms:.5f} ms")
    head = rows[" ".join(K5_HEADLINE)]
    return {"max_abs_err": max_err, "mismatch_frac": bad_lanes / all_lanes,
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "lanes")},
            "headline": " ".join(K5_HEADLINE), "lane_sets": rows, "stream_dead_ms": floor_ms}


def k5_share(scene, label, w, h, spp):
    """K5's share of K4 at room5 ``w`` x ``h``, spp ``spp``: K4 on ``scene``
    and on its twin without texture ids (the same geometry and materials,
    no fetch), in turns (with, without, without, with). The plain tracer
    must count the same live nodes and traced shadow sweeps for both (a
    texture changes no ray). Returns the entry."""
    import torch

    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P

    twin = dataclasses.replace(scene, tex_id=tuple(-1 for _ in scene.tex_id))
    o, d = P._cached_rays5(w, h, (0.5, 0.5), "cuda")
    state = P._state5(w * h, W5_SEED, "cuda")
    works = []
    for sc in (scene, twin):
        works.append({})
        P.trace_passes(sc, o, d, state, spp=spp, work=works[-1])
    for key in ("nodes", "lit", "shadow_sweeps_used", "glossy"):
        check(works[0][key] == works[1][key], f"K5 share {label}: {key} {works[0][key]} with "
              f"textures, {works[1][key]} without")
    calls = {"with": lambda: w5k.whitted5_trace_cuda(scene, o, d, state, spp=spp),
             "without": lambda: w5k.whitted5_trace_cuda(twin, o, d, state, spp=spp)}
    got = {"with": [], "without": []}
    for which in ("with", "without", "without", "with"):
        got[which].append(launch_ms(calls[which], n=5)[0])
    with_ms, without_ms = (statistics.mean(got[k]) for k in ("with", "without"))
    fetches = works[0]["texels"]
    share = (with_ms - without_ms) / with_ms
    torch.cuda.synchronize()
    print(f"  K5's share of K4, {label}, room5 {w}x{h} spp {spp}: K4 with textures "
          f"{got['with'][0]:.4f} / {got['with'][1]:.4f} ms, without "
          f"{got['without'][0]:.4f} / {got['without'][1]:.4f} ms (the same {works[0]['nodes']} "
          f"live nodes and {works[0]['shadow_sweeps_used']} traced shadow sweeps); share "
          f"{share:.2%}, {fetches} fetches, {(with_ms - without_ms) * 1e6 / fetches:.4f} ns per "
          f"fetch (the uv mapping included)")
    return dict(with_ms=with_ms, without_ms=without_ms, share=share, fetches=fetches)


def k4_contract(a, b, tag, idx_a=None, idx_b=None):
    """K4's output against its plain version's: p99 of |diff|, the share of
    components outside isclose(1e-3, 1e-3), the image means, the primary hit
    ids. Returns (max_abs_err, mismatch share)."""
    import torch

    check(bool(torch.isfinite(a).all()), f"{tag}: not finite")
    d = (a - b).abs().flatten()
    p99 = torch.quantile(d.float()[: 1 << 24], 0.99).item()
    bad = (~torch.isclose(a, b, rtol=1e-3, atol=1e-3)).double().mean().item()
    ma, mb = a.double().mean().item(), b.double().mean().item()
    line = (f"  {tag}: max_abs_err {d.max().item():.6g}, p99 {p99:.3g}, outside isclose "
            f"{bad:.4%}, bitwise {(d == 0).double().mean().item():.4%}, mean {ma:.7f} vs {mb:.7f}")
    if idx_a is not None:
        same = (idx_a.long() == idx_b.long()).double().mean().item()
        line += f", primary ids equal {same:.4%}"
        check(same >= K4_IDX, f"{tag}: primary hit ids equal on only {same:.4%}")
    print(line)
    check(p99 < K4_P99, f"{tag}: p99 {p99}")
    check(bad <= K4_BAD, f"{tag}: {bad:.3%} components outside isclose")
    check(abs(ma - mb) <= K4_MEAN_RTOL * abs(mb), f"{tag}: means differ")
    return d.max().item(), bad


def k4_box_tests(scene, o, d, state):
    """K4's exact box tests per sweep, counted by the torch mirror of its
    sweeps (``nearest_keeps``, ``shadow_visible``) over every sweep of the
    plain tracer's spp-1 trace, beside the plain work the bound counts (a
    sweep tests every box) and the shadow sweeps K4 traces (those whose
    diffuse or specular term can use the shade)."""
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P

    near, shadow, work = {}, {}, {}

    def hook(o_, d_, mask, max_t, target):
        o_, d_ = o_[mask], d_[mask]
        if max_t is None:
            w5k.nearest_keeps(scene, o_, d_, counts=near)
        else:
            w5k.shadow_visible(scene, o_, d_, max_t[mask], target, counts=shadow)

    P.trace_passes(scene, o, d, state, work=work, on_sweep=hook)
    n_box = sum(1 for t in scene.ptype if t == 2)
    out = dict(nearest_per_sweep=near["box_tests"] / near["sweeps"],
               shadow_per_sweep=shadow["box_tests"] / shadow["sweeps"], boxes=n_box,
               shadow_sweeps=work["shadow_sweeps"], shadow_sweeps_traced=work["shadow_sweeps_used"])
    print(f"  K4's exact box tests (torch mirror of its sweeps, spp 1): "
          f"{out['nearest_per_sweep']:.4f} per nearest sweep, {out['shadow_per_sweep']:.4f} per "
          f"shadow sweep (the light's own included), against {n_box} per sweep in the plain work "
          f"that the bound counts; K4 traces, and the bound counts, {out['shadow_sweeps_traced']} "
          f"of the {out['shadow_sweeps']} shadow sweeps drawn (the others cannot add light)")
    return out


def w5_work_ops(scene, work, shadow="shadow_sweeps_used"):
    """FP32 ops of the live whitted5 work the plain tracer counted: each
    live node's sweep and shading, and the shadow sweeps of ``work[shadow]``,
    by default those whose shade the node's diffuse or specular term can use
    (the others change no output, and K4 does not trace them); ``shadow=
    "shadow_sweeps"`` counts every shadow sweep drawn, the earlier yardstick.
    Every sweep tests every primitive, as the plain tracer does."""
    n_sph = sum(1 for t in scene.ptype if t == 0)
    n_pla = sum(1 for t in scene.ptype if t == 1)
    n_box = scene.num_prims - n_sph - n_pla
    sweep = W5_OPS_SPHERE * n_sph + W5_OPS_PLANE * n_pla + W5_OPS_BOX * n_box
    lights = sum(1 for x in scene.is_light if x)
    return (work["nodes"] * (sweep + W5_OPS_NODE) + work["lit"] * lights * W5_OPS_LIGHT
            + work[shadow] * (sweep + W5_OPS_SAMPLE) + work["texels"] * W5_OPS_TEXEL
            + work["glossy"] * W5_OPS_GLOSSY)


def w5_state_check(r, state):
    """The whitted5 counter state that the seed kernel makes on the card,
    bitwise numpy's hash (``_init_state5_np``): the whole ``r``-pixel frame
    at ``W5_SEED`` (``state``) and at a seed past 32 bits, and each shard's
    lanes (``lane_offset``) at 8 shards and at 7, whose last shard has pad
    lanes (state 2)."""
    import torch

    from se195_raytracer_tpu_torch.models import whitted5 as P

    cases = 0
    for seed in (W5_SEED, 2**62 - 1):
        want = [torch.from_numpy(x.astype("int64")) for x in P._init_state5_np(r, seed)]
        got = state if seed == W5_SEED else P._state5(r, seed, "cuda")
        check(all(g.dtype == torch.uint32 for g in got), f"whitted5 state dtype {got[0].dtype}")
        check(all(torch.equal(g.cpu().to(torch.int64), x) for g, x in zip(got, want)),
              f"whitted5 state, seed {seed}: the card's words differ from numpy's")
        cases += 1
        for shards in (SHARDS, 7):
            per = -(-r // shards)
            for k in range(shards):
                lo, hi = min(k * per, r), min((k + 1) * per, r)
                key, ctr = P._state5(r, seed, "cuda", lanes=per, lane_offset=lo)
                for g, x in zip((key, ctr), want):
                    pad = torch.full((per - (hi - lo),), 2, dtype=torch.int64)
                    check(torch.equal(g.cpu().to(torch.int64), torch.cat([x[lo:hi], pad])),
                          f"whitted5 state, seed {seed}, shard {k} of {shards}: the card's "
                          f"words differ from numpy's slice padded with 2")
                cases += 1
    print(f"  whitted5 state on the card: {cases} frames and shards bitwise numpy's hash "
          f"(seeds {W5_SEED} and 2^62-1, {SHARDS} and 7 shards)")


def k4_section(tmp):
    """Phases 10-12: K4 against the plain tracer, the whitted5 main paths,
    the timings."""
    import torch

    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P
    from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S

    w, h = W5_SIZES[-1]
    r = w * h
    scene = S.WHITTED5_SCENES["room5"]("cuda")
    print(f"[10] K4 against the plain tracer: room5 {w}x{h}, spp 1, seed {W5_SEED}, depth "
          f"{P.TRACEDEPTH5}, textures {[tuple(t.shape) for t in scene.textures]}")
    o, d = P._cached_rays5(w, h, (0.5, 0.5), "cuda")
    state = P._state5(r, W5_SEED, "cuda")
    w5_state_check(r, state)
    col, st, idx = w5k.whitted5_trace_cuda(scene, o, d, state, return_primary_idx=True)
    pcol, pst, pidx = P.trace_passes(scene, o, d, state, return_primary_idx=True)
    check(torch.equal(st[1], pst[1]), "K4: RNG counters differ from the plain version's")
    errs = [k4_contract(col, pcol, "K4 room5 spp 1", idx, pidx)]
    det = S.Whitted5Builder()
    det.plane((0.0, 1.0, 0.0), 4.4, color=(0.4, 0.3, 0.3), diff=1.0, spec=0.4)
    det.sphere((1.0, -0.8, 3.0), 2.5, color=(0.7, 0.7, 1.0), refl=0.4, diff=0.2)
    det.sphere((-2.0, 0.5, 6.0), 1.5, color=(1.0, 0.4, 0.4), refr=0.8, refr_index=1.3, diff=0.1)
    det.sphere((0.0, 5.0, 5.0), 0.1, color=(0.6, 0.6, 0.6), is_light=True)
    det = det.build("cuda")
    a = P.render_whitted5(det, w, h, spp=1, seed=0)
    b = P.render_whitted5(det, w, h, spp=1, seed=0, use_kernel=False)
    derr = (a - b).abs().max().item()
    print(f"  deterministic scene {w}x{h}: max_abs_err {derr:.3g}")
    check(bool(torch.allclose(a, b, rtol=K4_DET_TOL, atol=K4_DET_TOL)), "K4 deterministic scene")
    box_tests = k4_box_tests(scene, o, d, state)

    print(f"[11] whitted5 main paths: room5 {w}x{h}")
    main_launches = {}
    frames = {}

    def counted(label, fn, want_k4):
        zero_counters()
        out = fn()
        torch.cuda.synchronize()
        got = read_counters()
        others = {k: v for k, v in got.items() if k not in ("K4", "K5", "Seed")}
        print(f"  {label}: launches {got}")
        # Each render seeds its counter state on the card once.
        check(got["K4"] == want_k4 and got["K5"] == want_k4 and got["Seed"] == 1
              and not any(others.values()),
              f"{label}: launches {got}, want {want_k4} K4 (K5 inside), one Seed, nothing else")
        for k in ("K4", "K5"):
            main_launches[k] = main_launches.get(k, 0) + got[k]
        return out

    base = ["render", "--integrator", "whitted5", "--width", str(w), "--height", str(h),
            "--seed", str(W5_SEED)]
    for extra, want in ((["--spp", str(W5_SPP)], 1), (["--adaptive"], 2)):
        png = os.path.join(tmp, "room5.png")
        rc = counted("cli " + " ".join(extra),
                     lambda: cli.main(base + extra + ["--out", png]), want)
        check(rc == 0, f"cli whitted5 {extra} exited {rc}")
        with open(png, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "cli output is not a PNG")
    frames["spp8"] = counted(f"render_whitted5 spp {W5_SPP}", lambda: P.render_whitted5(
        scene, w, h, spp=W5_SPP, seed=W5_SEED), 1)
    frames["4ray"] = counted("render_whitted5_4ray", lambda: P.render_whitted5_4ray(
        scene, w, h, seed=W5_SEED), 1)
    P.adaptive_pipeline(scene, w, h, seed=W5_SEED)  # caches this size's rays

    def adaptive_no_sync():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return P.adaptive_pipeline(scene, w, h, seed=W5_SEED)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    frames["adaptive"], n_edge = counted("adaptive_pipeline (no host sync)", adaptive_no_sync, 2)
    k4_reference_textures(tmp, base, counted)
    frac = int(n_edge) / r
    print(f"  adaptive: edge fraction {frac:.6f} ({int(n_edge)} of {r} pixels), bucket "
          f"{P.adaptive_bucket(w, h)}")
    plain = {
        "spp8": P.render_whitted5(scene, w, h, spp=W5_SPP, seed=W5_SEED, use_kernel=False),
        "4ray": P.render_whitted5_4ray(scene, w, h, seed=W5_SEED, use_kernel=False),
    }
    pa, pfrac = P.render_whitted5_adaptive(scene, w, h, seed=W5_SEED, use_kernel=False)
    plain["adaptive"] = pa
    check(pfrac == frac, f"adaptive edge fraction {frac} vs plain {pfrac}")
    for key in ("spp8", "4ray", "adaptive"):
        check(tuple(frames[key].shape) == (h, w, 3), f"{key}: shape {tuple(frames[key].shape)}")
        errs.append(k4_contract(frames[key], plain[key], f"main path {key} vs plain"))

    print("[12] whitted5 timings (room5)")
    cells = {}
    for cw, ch in W5_SIZES:
        for cfg in ("spp1", f"spp{W5_SPP}", "4ray", "adaptive"):
            cells[f"{cw}x{ch} {cfg}"] = w5_cell(scene, cw, ch, cfg)
    diag = {"box_tests": box_tests, "split": k4_split(scene, w, h, {})}
    k5_shares = {form: k5_share(sc, f"{form} textures", w, h, W5_SPP)
                 for form, sc in k5_atlases(tmp).items()}
    return errs, main_launches, cells, frac, diag, k5_shares


def k4_reference_textures(tmp, base, counted):
    """The path of users with the reference's TGA assets: room5 resolves to
    the files in ``tmp`` (u8/256, 200 x 200, written by k5_section) through
    SE195_REF_TEXTURES, and its textures take K5's u8 form. The CLI at spp
    8, render_whitted5 at spp 8 (counted, bitwise against the plain render)
    and K4 at spp 1 (colour, counters and primary ids bitwise against the
    plain tracer), at room5 800x600."""
    import torch

    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P
    from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S

    w, h = W5_SIZES[-1]
    saved = os.environ.get(S.REF_TEXTURES_ENV)
    os.environ[S.REF_TEXTURES_ENV] = tmp
    try:
        png = os.path.join(tmp, "room5_tga.png")
        rc = counted(f"cli --spp {W5_SPP} (room5 with the TGA textures)",
                     lambda: cli.main(base + ["--spp", str(W5_SPP), "--out", png]), 1)
        check(rc == 0, f"cli whitted5 with TGA textures exited {rc}")
        scene = S.WHITTED5_SCENES["room5"]("cuda")
    finally:
        if saved is None:
            os.environ.pop(S.REF_TEXTURES_ENV)
        else:
            os.environ[S.REF_TEXTURES_ENV] = saved
    shapes = [tuple(t.shape) for t in scene.textures]
    forms = w5k._packed(scene)[3].table[:, 3].tolist()
    check(shapes == [(200, 200, 3)] * 2 and forms == [tk.TEX_U8] * 2,
          f"room5 with TGA textures: shapes {shapes}, forms {forms}")
    frame = counted(f"render_whitted5 spp {W5_SPP} (TGA textures)", lambda: P.render_whitted5(
        scene, w, h, spp=W5_SPP, seed=W5_SEED), 1)
    plain = P.render_whitted5(scene, w, h, spp=W5_SPP, seed=W5_SEED, use_kernel=False)
    o, d = P._cached_rays5(w, h, (0.5, 0.5), "cuda")
    state = P._state5(w * h, W5_SEED, "cuda")
    col, st, idx = w5k.whitted5_trace_cuda(scene, o, d, state, return_primary_idx=True)
    pcol, pst, pidx = P.trace_passes(scene, o, d, state, return_primary_idx=True)
    same = {"spp 8 frame": torch.equal(frame, plain), "spp 1 colour": torch.equal(col, pcol),
            "spp 1 counters": torch.equal(st[1], pst[1]),
            "spp 1 primary ids": torch.equal(idx.long(), pidx)}
    print(f"  room5 {w}x{h} with u8/256 200x200 TGA textures (u8 form), K4 against the plain "
          f"tracer, bitwise: {same}; spp 8 max_abs_err {(frame - plain).abs().max().item():.3g}")
    check(all(same.values()), f"K4 with TGA textures not bitwise: {same}")


def launch_ms(fn, n=20, reps=5):
    """Median over ``reps`` of the time per call of ``n`` calls in a row
    between two CUDA events (one warm-up call first): back-to-back launches
    keep the card busy while the host enqueues, so small kernels are not
    timed as host latency."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times), times


def queued_ms(fn, n=50, reps=5):
    """Device time per call of ``fn`` (launches only, no host sync): ``n``
    calls enqueued behind a ``torch.cuda._sleep`` that outlasts their
    enqueue, between two CUDA events, so they run back to back on the card
    and the events time the device, not the host's launch rate. Median
    over ``reps``, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t
    # Clock cycles of the sleep: twice the measured enqueue time at 2 GHz.
    cycles = int(2 * enqueue_s * 2e9) + 1_000_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times), times


def device_ms(fn, name=None, n=20):
    """Device time per call of ``fn`` over ``n`` calls under torch.profiler
    (one warm-up call first): the summed device time of the kernels whose
    name holds ``name`` (every kernel when None). For a kernel of a few
    microseconds this is its own time, where back-to-back launches time the
    host's enqueue of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The profiler has come back without some or all of a session's kernel
    # events after many sessions in one process. A session counts only when
    # every kernel it names ran a whole number of times per call; else it
    # is made again, up to 3 times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total, whole = 0.0, True
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if t > 0 and (name is None or name in e.key):
                total += t
                whole = whole and e.count % n == 0
        if total > 0 and whole:
            return total / n / 1e3
    raise RuntimeError(f"check failed: profiler: no whole session for {name or 'any kernel'}")


def device_profile(fn, reps=5, host=True):
    """(wall ms, device-busy ms, K4 device ms) per call of ``fn`` over
    ``reps`` calls under torch.profiler: the card's idle share is 1 - busy /
    wall, at least 0 (the profiler's own overhead is in the wall time, and
    its device time sums activities that overlap, such as a copy and a
    kernel, so busy can pass wall by a hair). Busy sums the card's own
    events only (``on_device``); ``host=False`` traces only those."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps

    events = [e for e in prof.key_averages() if on_device(e)]
    busy = sum(dev_time(e) for e in events) / reps / 1e3
    k4 = sum(dev_time(e) for e in events if "whitted5_kernel" in e.key) / reps / 1e3
    return wall, busy, k4


def dev_time(e) -> float:
    """An averaged profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def on_device(e) -> bool:
    """True for the events of the card itself (kernels, copies). An operator
    on the host carries its kernels' device time too, so a sum over both
    would count it twice."""
    return getattr(e, "device_type", None) is not None and e.device_type.name != "CPU"


def w5_cell(scene, w, h, cfg):
    """One timing cell: K4 ms (CUDA events, back-to-back launches; for the
    adaptive render the two K4 launches' device time from the profiler), end
    to end with readback (host clock), the card's idle share over the end to
    end, plain ms, launches, peak memory, the bound from the plain tracer's
    live work."""
    import torch

    from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
    from se195_raytracer_tpu_torch.models import whitted5 as P

    r = w * h
    state = P._state5(r, W5_SEED, "cuda")
    if cfg.startswith("spp"):
        spp = int(cfg[3:])
        o, d = P._cached_rays5(w, h, (0.5, 0.5), "cuda")
        render = lambda **kw: P.render_whitted5(scene, w, h, spp=spp, seed=W5_SEED, **kw)
        kernel = lambda: w5k.whitted5_trace_cuda(scene, o, d, state, spp=spp)
        n_sets = 1
    elif cfg == "4ray":
        o, d = P._cached_rays5_4(w, h, "cuda")
        render = lambda **kw: P.render_whitted5_4ray(scene, w, h, seed=W5_SEED, **kw)
        kernel = lambda: w5k.whitted5_trace_cuda(scene, o, d, state, spp=4)
        n_sets = 4
    else:
        render = lambda **kw: P.render_whitted5_adaptive(scene, w, h, seed=W5_SEED, **kw)[0]
        kernel = None
        n_sets = None
    zero_counters()
    img = render()
    torch.cuda.synchronize()
    launches = read_counters()["K4"]
    torch.cuda.reset_peak_memory_stats()
    e2e_ms, eall = host_ms(lambda: render().cpu(), reps=5)
    peak = torch.cuda.max_memory_allocated()
    wall, busy, k4_dev = device_profile(lambda: render().cpu())
    idle = max(0.0, 1 - busy / wall)
    if kernel is None:
        pipe_ms, kall = launch_ms(lambda: P.adaptive_pipeline(scene, w, h, seed=W5_SEED), n=5)
        kernel_ms = k4_dev
    else:
        kernel_ms, kall = launch_ms(kernel, n=20 if w * h * (n_sets or 1) < 1 << 20 else 5)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    render(use_kernel=False)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    work = {}
    render(use_kernel=False, work=work)
    ops = w5_work_ops(scene, work)
    ops_drawn = w5_work_ops(scene, work, "shadow_sweeps")
    if n_sets is None:  # adaptive: the primary pass and 3 passes over the bucket
        bucket = P.adaptive_bucket(w, h)
        nbytes = r * (24 + 8 + 12 + 4) + 3 * bucket * 24 + bucket * (8 + 12)
    else:
        nbytes = n_sets * r * 24 + r * 8 + r * 12
    nbytes += sum(t.numel() * 4 for t in scene.textures)
    what = "K4 (2 launches, profiler)" if kernel is None else "K4"
    line = f"  {w}x{h} {cfg}: {what} {kernel_ms:.4f} ms"
    if kernel is None:
        line += f"; the whole pipeline {pipe_ms:.4f} ms per call in a row"
    print(f"{line} (reps {min(kall):.4f}-{max(kall):.4f}); e2e with readback {e2e_ms:.4f} ms "
          f"(reps {min(eall):.4f}-{max(eall):.4f}); under the profiler wall {wall:.4f} ms, card "
          f"busy {busy:.4f} ms (K4 {k4_dev:.4f}), idle share {idle:.2%}; plain "
          f"{plain_ms:.2f} ms; K4 launches {launches}; peak memory {peak} B; work {work}")
    bound_ms, bound_by = bound(ops, nbytes, kernel_ms, f"{w}x{h} {cfg}")
    drawn_ms = max(ops_drawn / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    print(f"  {w}x{h} {cfg} against every drawn shadow sweep ({work['shadow_sweeps']}, of which "
          f"{work['shadow_sweeps_used']} can add light; the earlier yardstick): {ops_drawn:.6g} "
          f"FP32 ops, bound {drawn_ms:.5f} ms, share {drawn_ms / kernel_ms:.2%}")
    return {"ms": kernel_ms, "e2e_ms": e2e_ms, "plain_ms": plain_ms, "launches": launches,
            "peak_mem_bytes": peak, "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bound_ms_every_shadow_sweep": drawn_ms,
            "bytes": nbytes, "idle_share": idle, "busy_ms": busy, "work": work,
            "img": img}


def w5_summary(cells, k5, errs, main_launches, frac, diag, k5_shares):
    """The adaptive A/B lines and the K4 and K5 entries of the kernels line."""
    for size in W5_SIZES:
        key = f"{size[0]}x{size[1]}"
        ref = cells[f"{key} 4ray"]["img"]
        ratio = cells[f"{key} adaptive"]["e2e_ms"] / cells[f"{key} 4ray"]["e2e_ms"]
        print(f"  {key}: adaptive / 4-ray wall clock (e2e) {ratio:.4f}; PSNR vs 4-ray: brute 1-ray "
              f"{psnr(cells[f'{key} spp1']['img'], ref):.3f} dB, adaptive "
              f"{psnr(cells[f'{key} adaptive']['img'], ref):.3f} dB")
        for c in ("spp1", f"spp{W5_SPP}", "4ray", "adaptive"):
            cells[f"{key} {c}"].pop("img")
    big = cells[f"{W5_SIZES[-1][0]}x{W5_SIZES[-1][1]} spp{W5_SPP}"]
    k4 = {
        "name": "K4 whitted5_trace_cuda",
        "route": "cuda",
        "designed_in": designed_in("K4"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/whitted5_kernel.cu",
        "replaces": "se195_raytracer_tpu/kernels/whitted5_kernel.py:151",
        "launches": main_launches["K4"],
        "max_abs_err": max(e[0] for e in errs),
        "mismatch_frac": max(e[1] for e in errs),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "e2e_ms": big["e2e_ms"],
        "edge_fraction": frac,
        "cells": cells,
        **diag,
    }
    k5e = {
        "name": "K5 texel fetch (device function inside K4; texel_fetch_cuda alone)",
        "route": "cuda",
        "designed_in": designed_in("K5"),
        "source": "se195_raytracer_tpu_torch/kernels/csrc/whitted5_kernel.cu",
        "replaces": "se195_raytracer_tpu/kernels/texel_kernel.py:116",
        "launches": main_launches["K5"],
        **{k: k5[k] for k in ("max_abs_err", "mismatch_frac", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "lanes", "headline", "lane_sets",
                              "stream_dead_ms")},
        "fetches_per_render": {"800x600 spp 1": int(k5["lane_sets"][f"u8 {K5_STREAM}"]["lanes"]),
                               f"800x600 spp {W5_SPP}": k5_shares["u8"]["fetches"]},
        "share_of_k4": k5_shares,
    }
    return k4, k5e


# The sharded phase: 8 shards on cuda:0 (the in-process mesh), and two
# processes on the one card (gloo).
SHARDS = 8
SHARD_CELLS = (("K1", "cornell", 512, 512, 8), ("K2", COMPLEX, 512, 512, 8))
SHARD_GRAD = dict(width=128, height=128, spp=1)
GRAD_SHARD_RTOL, GRAD_SHARD_ATOL = 1e-5, 1e-7  # tests/test_sharding.py:127
SESSION_CALLS = (25, 5)  # step_for calls before and after the camera edit
SESSION_BUDGET_S = 0.02
BIG_WHITTED_PRIMS = 1000
BIG_WHITTED = dict(width=200, height=150, supersample=1, trace_depth=5)
TWO_PROCESS_TIMEOUT_S = 300

# One rank of the two-process render: argv port, rank, output .npy path.
_RANK_SCRIPT = r"""
import json, sys, time
import numpy as np
import torch
from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.kernels import seed_kernel as sk
from se195_raytracer_tpu_torch.parallel import render_sharded as rs
from se195_raytracer_tpu_torch.parallel.mesh import make_mesh
from se195_raytracer_tpu_torch.scenes.registry import get_scene
import torch.distributed as dist

port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rs.initialize_multihost(f"127.0.0.1:{port}", 2, rank)
mesh = make_mesh("cuda:0", process_group=True)
spec = get_scene("cornell")
scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
cfg = RenderConfig(width=512, height=512, spp=8, seed=0)
rs.render_cuda_sharded(scene, cam, cfg, mesh)  # warm-up: load the kernels
times = []
ptk.pt_multi_pass.launches = sk.seed_lanes.launches = 0
for _ in range(5):
    dist.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    img, _ = rs.render_cuda_sharded(scene, cam, cfg, mesh)
    img = img.cpu()
    times.append((time.perf_counter() - t) * 1e3)
if rank == 0:
    np.save(out, img.numpy())
print(json.dumps({"rank": rank, "ms": sorted(times)[2], "times": times,
                  "k1_launches_per_render": ptk.pt_multi_pass.launches / 5,
                  "seed_launches_per_render": sk.seed_lanes.launches / 5}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def e2e_ms(fn, reps=REPS):
    """host_ms of a render whose image is read back to the host."""
    return host_ms(lambda: fn().cpu(), reps)


def _sharded_cell(label, single_fn, sharded_fn, want):
    """Run ``sharded_fn`` with every counter at 0 (and the plain ``radiance``
    counted), hold its image bitwise to ``single_fn``'s, time both end to
    end (with readback). ``want`` names the kernel each shard launches."""
    import torch

    single = single_fn()
    zero_counters()
    calls, undo = count_plain_radiance()
    try:
        sharded = sharded_fn()
        torch.cuda.synchronize()
    finally:
        undo()
    launches = read_counters()
    same = bool(torch.equal(sharded, single))
    diff = (sharded - single).abs().max().item()
    check(bool(torch.isfinite(sharded).all()), f"{label}: sharded image not finite")
    # K5 runs inside each K4 launch on a textured scene; each K1/K2/K4
    # shard seeds its own lanes in the seed kernel.
    seeds = SHARDS if want in ("K1", "K2", "K4") else 0
    others = {k: v for k, v in launches.items()
              if k not in (want, "Seed", "K5" if want == "K4" else want)}
    check(launches[want] == SHARDS and launches["Seed"] == seeds and not any(others.values())
          and calls["n"] == 0,
          f"{label}: launches {launches}, plain radiance calls {calls['n']} (want {SHARDS} "
          f"{want}, {seeds} Seed, nothing else)")
    one_ms, _ = e2e_ms(single_fn)
    n_ms, n_times = e2e_ms(sharded_fn)
    print(f"  {label}: {SHARDS} shards bitwise equal to one launch: {same} (max |diff| "
          f"{diff:.3g}); launches {launches}; e2e {n_ms:.4f} ms for {SHARDS} launches on one "
          f"card against {one_ms:.4f} ms for one ({n_ms / one_ms:.4f}x)")
    check(same, f"{label}: sharded image differs from the single-device render by {diff}")
    return {"bitwise": same, "launches": launches, "e2e_ms": n_ms, "single_e2e_ms": one_ms,
            "ratio": n_ms / one_ms, "times": n_times}


def big_whitted_scene(device):
    """A Whitted scene of BIG_WHITTED_PRIMS primitives (past the ~500 that
    fit in 48 KB of shared memory): grid_scene's planes, lights and feature
    spheres, and a 31 x 32 grid of small spheres behind them."""
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WhittedSceneBuilder, _adders, _mat

    b = WhittedSceneBuilder()
    plane, sphere = _adders(b)
    plane(_mat(0.4, 0.3, 0.3, 0.0, 0.0, 1.0, 1.0, 0.8), False, 0.0, 1.0, 0.0, 4.4)
    sphere(_mat(0.7, 0.7, 1.0, 0.0, 1.0, 1.3, 0.2, 0.8), False, 2.0, 0.8, 3.0, 2.5)
    sphere(_mat(0.7, 0.7, 1.0, 0.5, 0.0, 1.0, 0.1, 0.8), False, -5.5, -0.5, 7.0, 2.0)
    sphere(_mat(0.4, 0.4, 0.4, 0.0, 0.0, 1.0, 0.0, 0.0), True, 0.0, 5.0, 5.0, 0.1)
    sphere(_mat(0.6, 0.6, 0.8, 0.0, 0.0, 1.0, 0.0, 0.0), True, -3.0, 5.0, 1.0, 0.1)
    sphere(_mat(1.0, 0.4, 0.4, 0.5, 0.0, 1.0, 0.2, 0.8), False, -1.5, -3.8, 1.0, 1.5)
    plane(_mat(0.5, 0.3, 0.5, 0.0, 0.0, 1.0, 0.6, 0.0), False, 0.4, 0.0, -1.0, 12.0)
    plane(_mat(0.4, 0.7, 0.7, 0.0, 0.0, 1.0, 0.5, 0.0), False, 0.0, -1.0, 0.0, 7.4)
    for x in range(32):
        for y in range(31):
            sphere(_mat(0.3 + 0.02 * (x % 8), 1.0, 0.4, 0.2 * (y % 2), 0.0, 1.0, 0.6, 0.6),
                   False, -5.4 + x * 0.35, -4.3 + y * 0.3, 10.0, 0.12)
    scene = b.build(device)
    check(scene.num_prims == BIG_WHITTED_PRIMS, f"big Whitted scene has {scene.num_prims}")
    return scene


def two_process_render(tmp):
    """Two ranks on cuda:0 over gloo (initialize_multihost, all_gather):
    Cornell 512x512 x 8 spp through K1, one shard a rank. Returns (rank 0's
    frame, each rank's JSON line)."""
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = os.path.join(tmp, "two_process.npy")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(port), str(rank), out],
                              cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=TWO_PROCESS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{err[-3000:]}")
    lines = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    return np.load(out), lines


def sharded_section(tmp):
    """Phase S: the sharded and multi-process paths, the 3,908-sphere scene
    through K2, the 1,000-primitive Whitted scene through K3, the session,
    the checkpoint, ``bench``, a ``.scn`` scene and ``--profile``."""
    import contextlib
    import io

    import numpy as np
    import torch

    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver import checkpoint as ck
    from se195_raytracer_tpu_torch.driver.optimize import LEAVES, l2_image_loss
    from se195_raytracer_tpu_torch.driver.session import RenderSession
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.models import whitted as W
    from se195_raytracer_tpu_torch.models.whitted5 import render_whitted5
    from se195_raytracer_tpu_torch.parallel import render_sharded as rs
    from se195_raytracer_tpu_torch.parallel.mesh import make_mesh
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene
    from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    res = {}
    mesh = make_mesh("cuda:0", n_devices=SHARDS)
    print(f"[S1] sharded renders, {SHARDS} shards on cuda:0, each bitwise against one launch "
          "(end to end with readback: the cost of N launches on one card, no scaling claim)")
    for kernel, name, w, h, spp in SHARD_CELLS:
        spec = get_spec(name)
        scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
        cfg = RenderConfig(width=w, height=h, spp=spp, seed=SEED)
        rp = ptk.ray_layout(w, h, kernel == "K2", SHARDS)[0]
        res[f"{name} {w}x{h} spp{spp}"] = cell = _sharded_cell(
            f"{name} {w}x{h} x {spp} spp ({kernel}, {rp // ptk.TILE} tiles)",
            lambda: ptk.render_cuda(scene, cam, cfg, device="cuda")[0],
            lambda: rs.render_cuda_sharded(scene, cam, cfg, mesh)[0], kernel)
        cell["tiles"] = rp // ptk.TILE
    # 640x480 in K2's blocked layout is 150 tiles: tile_multiple adds 2 pad tiles.
    spec = get_spec(COMPLEX)
    scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=640, height=480, spp=1, seed=SEED)
    tiles = (ptk.ray_layout(640, 480, True)[0] // ptk.TILE,
             ptk.ray_layout(640, 480, True, SHARDS)[0] // ptk.TILE)
    check(tiles == (150, 152), f"640x480 blocked tiles {tiles}")
    res["complex 640x480 spp1 pad tiles"] = _sharded_cell(
        "complex 640x480 x 1 spp (K2, 150 tiles + 2 pad tiles)",
        lambda: ptk.render_cuda(scene, cam, cfg, device="cuda")[0],
        lambda: rs.render_cuda_sharded(scene, cam, cfg, mesh)[0], "K2")
    w, h, ss, depth = WHITTED["width"], WHITTED["height"], WHITTED["supersample"], WHITTED["trace_depth"]
    room = WHITTED_SCENES["room"]("cuda")
    res[f"whitted room {w}x{h} ss{ss}"] = _sharded_cell(
        f"whitted room {w}x{h} {ss}x{ss} (K3: the explicit-ray entry per shard against the "
        "frame entry)",
        lambda: wk.render_whitted_cuda(room, w, h, ss, depth, device="cuda"),
        lambda: rs.render_whitted_sharded(room, w, h, ss, depth, mesh=mesh), "K3")
    room5 = room5_scene("procedural", device="cuda")
    w5, h5 = W5_SIZES[-1]
    res[f"room5 {w5}x{h5} spp{W5_SPP}"] = cell = _sharded_cell(
        f"room5 {w5}x{h5} spp {W5_SPP} (K4, K5 inside)",
        lambda: render_whitted5(room5, w5, h5, spp=W5_SPP, seed=W5_SEED, device="cuda"),
        lambda: rs.render_whitted5_sharded(room5, w5, h5, spp=W5_SPP, seed=W5_SEED, mesh=mesh),
        "K4")
    check(cell["launches"]["K5"] == SHARDS, f"K5 ran in {cell['launches']['K5']} K4 launches")
    # Each kernel's launches as counted in the sharded render that runs it
    # (K5: the K4 launches of the room5 render, inside which its fetch ran).
    k1_cell, k2_cell = (f"{name} {w}x{h} spp{spp}" for _, name, w, h, spp in SHARD_CELLS)
    res["launches_per_sharded_render"] = {
        "K1": res[k1_cell]["launches"]["K1"], "K2": res[k2_cell]["launches"]["K2"],
        "K3": res[f"whitted room {WHITTED['width']}x{WHITTED['height']} ss{ss}"]["launches"]["K3"],
        "K4": cell["launches"]["K4"], "K5": cell["launches"]["K5"],
        "Seed": res[k1_cell]["launches"]["Seed"]}

    print("[S2] two processes on cuda:0 (gloo: initialize_multihost, all_gather), Cornell "
          "512x512 x 8 spp through K1")
    spec = get_spec("cornell")
    scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=512, height=512, spp=8, seed=SEED)
    t = time.perf_counter()
    frame, lines = two_process_render(tmp)
    wall = time.perf_counter() - t
    one = ptk.render_cuda(scene, cam, cfg, device="cuda")[0].cpu().numpy()
    same = bool(np.array_equal(frame, one))
    one_ms, _ = e2e_ms(lambda: ptk.render_cuda(scene, cam, cfg, device="cuda")[0])
    for line in lines:
        print(f"  rank {line['rank']}: median e2e {line['ms']:.4f} ms (K1 launches per render "
              f"{line['k1_launches_per_render']}, seedings {line['seed_launches_per_render']}), "
              f"reps {[round(x, 4) for x in line['times']]}")
    print(f"  two-process frame bitwise equal to one process: {same} (max |diff| "
          f"{float(np.abs(frame - one).max()):.3g}); one process e2e {one_ms:.4f} ms; "
          f"the call with process start {wall:.2f} s")
    check(same, "two-process frame differs from the one-process render")
    # Each rank seeds only its own lanes: one seeding per render.
    check(all(line["k1_launches_per_render"] == line["seed_launches_per_render"] == 1
              for line in lines), f"rank launches {lines}")
    res["two_process"] = {"bitwise": same, "rank_e2e_ms": [x["ms"] for x in lines],
                          "single_e2e_ms": one_ms, "wall_s": wall}

    print(f"[S3] gradients across {SHARDS} shards, Cornell {SHARD_GRAD['width']}x"
          f"{SHARD_GRAD['height']} spp {SHARD_GRAD['spp']}, summed against one device "
          f"(rtol {GRAD_SHARD_RTOL}, atol {GRAD_SHARD_ATOL})")
    gcfg = RenderConfig(seed=SEED, **SHARD_GRAD)
    target = torch.zeros((gcfg.height, gcfg.width, 3), device="cuda")
    leaves, sc, c = grad_leaves(scene, cam)
    loss1 = l2_image_loss(sc, c, target, gcfg)
    grads1 = dict(zip(LEAVES, torch.autograd.grad(loss1, [leaves[k] for k in LEAVES])))
    zero_counters()
    t = time.perf_counter()
    loss8, grads8 = rs.l2_image_loss_sharded(scene, cam, target, gcfg, mesh)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t
    glaunch = read_counters()
    worst = 0.0
    for k in LEAVES:
        a, b = grads8[k].double(), grads1[k].double()
        check(bool(torch.isfinite(a).all()), f"sharded gradient of {k} not finite")
        rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
        ok = bool(torch.allclose(a, b, rtol=GRAD_SHARD_RTOL, atol=GRAD_SHARD_ATOL))
        worst = max(worst, (a - b).abs().max().item())
        print(f"  {k}: max |diff| {(a - b).abs().max().item():.4g}, max rel {rel:.4g}, "
              f"|g| max {b.abs().max().item():.4g}, within tolerance {ok}")
        check(ok, f"sharded gradient of {k} differs from the single-device one")
    check(glaunch["K1"] == glaunch["K1b"] == SHARDS, f"sharded gradient launches {glaunch} "
          f"(one K1 forward and one K1b backward per shard)")
    print(f"  loss {loss8.item():.9g} vs {loss1.item():.9g}; {glaunch['K1']} K1 launches; "
          f"{grad_s:.3f} s")
    res["gradients"] = {"max_abs_diff": worst, "k1_launches": glaunch["K1"],
                        "k1b_launches": glaunch["K1b"], "s": grad_s}

    print("[S4] capacity past 48 KB of shared memory")
    spec5 = complex_scene(max_depth=5.0)
    n5 = len(spec5.radius)
    check(n5 == 3908, f"complex_scene(max_depth=5) has {n5} spheres")
    zero_counters()
    mism, st_mism, mean, plain_mean = k2_against_plain(spec5, 512, 512)
    check(read_counters()["K2"] == 1, "the 3,908-sphere pass is not one K2 launch")
    tab, camt, st5, pix, kw = pass_inputs(spec5, 512, 512, "pt", "mwc", "cuda")
    smem = ptk.k2_shared_memory_bytes(n5, len(kw["light_indices"]))
    k2_ms, _ = median_ms(lambda: ptk.pt_multi_pass(tab, camt, 0, *st5, pix, num_samples=1,
                                                   **kw), 3)
    print(f"  complex_scene(max_depth=5): {n5} spheres, {smem} B of shared memory a block; K2 "
          f"512x512 x 1 spp {k2_ms:.4f} ms; against its plain version: mismatch {mism:.4%}, "
          f"state mismatch {st_mism:.4%}, mean {mean:.6f} vs {plain_mean:.6f}")
    check(mism <= MAX_MISMATCH and st_mism <= MAX_STATE_MISMATCH and
          abs(mean - plain_mean) <= MEAN_RTOL * abs(plain_mean),
          "the 3,908-sphere K2 pass misses K2's contract")
    big = big_whitted_scene("cuda")
    bw = BIG_WHITTED
    frame_smem = wk.shared_memory_bytes(big.num_prims, 3 * wk.pixels_per_block(bw["supersample"])
                                        * bw["supersample"] ** 2)
    zero_counters()
    frame = wk.whitted_frame_cuda(big, width=bw["width"], height=bw["height"],
                                  supersample=bw["supersample"], trace_depth=bw["trace_depth"])
    o, d = W.whitted_camera_rays_device(bw["width"], bw["height"], bw["supersample"], device="cuda")
    acc3 = wk.whitted_trace_cuda(big, wk.rays_to_tiles(o, d), trace_depth=bw["trace_depth"])
    via = wk.tiles_to_frame(acc3, bw["width"], bw["height"], bw["supersample"])
    check(read_counters()["K3"] == 2, "the 1,000-primitive frame is not two K3 launches")
    plain = W.render_whitted_scene(big, bw["width"], bw["height"], bw["supersample"],
                                   bw["trace_depth"], ray_tile=1 << 13)
    k3_ms, _ = median_ms(lambda: wk.whitted_frame_cuda(
        big, width=bw["width"], height=bw["height"], supersample=bw["supersample"],
        trace_depth=bw["trace_depth"]), 3)
    for entry, img in (("frame", frame), ("rays", via)):
        # Bitwise, NaN where the plain tracer has NaN: on this dense scene a
        # few trees' directions grow in length until a Phong term is inf * 0,
        # in the plain tracer, K3 and the JAX package's formulas alike.
        nan = img.isnan()
        same = bool(((img == plain) | (nan & plain.isnan())).all())
        fin = ~nan
        print(f"  Whitted {big.num_prims} primitives ({frame_smem} B a frame block), "
              f"{bw['width']}x{bw['height']} ss {bw['supersample']} depth {bw['trace_depth']}, "
              f"{entry} entry: bitwise equal to the plain tracer {same} (max |diff| "
              f"{(img[fin] - plain[fin]).abs().max().item():.3g}; NaN components {int(nan.sum())}"
              f" / plain {int(plain.isnan().sum())}), mean {img[fin].mean().item():.4f}")
        check(same, f"K3 {entry} entry on {big.num_prims} primitives differs from the plain tracer")
    print(f"  K3 frame entry {k3_ms:.4f} ms")
    res["capacity"] = {"k2_spheres": n5, "k2_smem_bytes": smem, "k2_ms": k2_ms,
                       "k2_mismatch": mism, "k3_prims": big.num_prims,
                       "k3_smem_bytes": frame_smem, "k3_ms": k3_ms}

    print(f"[S5] session: Cornell 512x512, {sum(SESSION_CALLS)} step_for calls "
          f"({SESSION_BUDGET_S} s budget), a camera edit after {SESSION_CALLS[0]}")
    spec = get_spec("cornell")
    sess = RenderSession(spec.to_scene("cuda"), spec.to_camera("cuda"),
                         RenderConfig(width=512, height=512, spp=1, seed=SEED))
    zero_counters()
    step_ms = []
    for _ in range(SESSION_CALLS[0]):
        t = time.perf_counter()
        sess.step_for(SESSION_BUDGET_S)
        step_ms.append((time.perf_counter() - t) * 1e3)
    before = sess.current_sample
    sess.key("left")
    check(sess.current_sample == 0, "an edit did not restart the accumulation")
    kept = (sess.state[0].clone(), sess.state[1].clone(), torch.zeros_like(sess.state[2]), 0)
    first = None
    for _ in range(SESSION_CALLS[1]):
        t = time.perf_counter()
        img = sess.step_for(SESSION_BUDGET_S)
        step_ms.append((time.perf_counter() - t) * 1e3)
        first = img if first is None else first
    fresh = ptk.render_cuda(sess.scene, sess.camera, RenderConfig(width=512, height=512, spp=1,
                                                                  seed=SEED), device="cuda",
                            state=kept)[0]
    same = bool(np.array_equal(first, fresh.cpu().numpy()))
    launches = read_counters()
    print(f"  samples {before} before the edit; after it the image is bitwise a fresh render "
          f"from the kept seeds: {same}; launches {launches}; step_for ms: median "
          f"{statistics.median(step_ms[:20]):.4f} (1 pass), {statistics.median(step_ms[20:25]):.4f}"
          f" (ladder, past 20 samples)")
    check(same, "the image after the edit is not a fresh render from the kept seeds")
    check(launches["K1"] >= sum(SESSION_CALLS) and launches["K2"] == 0, f"session launches {launches}")
    res["session"] = {"step_ms_1pass": statistics.median(step_ms[:20]),
                      "step_ms_ladder": statistics.median(step_ms[20:25]),
                      "samples_before_edit": before, "k1_launches": launches["K1"]}

    print("[S6] checkpoint on the card; cli bench; render --scene .scn --profile")
    cfg = RenderConfig(width=512, height=512, spp=4, seed=SEED)
    scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    _, st = ptk.render_cuda(scene, cam, cfg, device="cuda")
    path = os.path.join(tmp, "ckpt.npz")
    ck.save_render_state(path, st)
    a, _ = ptk.render_cuda(scene, cam, cfg, device="cuda", state=st)
    b, _ = ptk.render_cuda(scene, cam, cfg, device="cuda", state=ck.load_render_state(path))
    same = bool(torch.equal(a, b))
    print(f"  checkpoint save, load, resume 4 + 4 spp: bitwise {same}")
    check(same, "the resumed checkpoint differs from the live resume")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--scene", "cornell", "--width", "512", "--height", "512",
                       "--spp", "8", "--reps", "3"])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"bench exited {rc} with {len(lines)} lines")
    bench = json.loads(lines[0])
    print(f"  bench: {lines[0]}")
    check(set(bench) == {"scene", "width", "height", "spp", "integrator", "device", "elapsed_s",
                         "rays_per_sec"}, f"bench keys {sorted(bench)}")
    root = os.path.dirname(os.path.abspath(__file__))
    scn = os.path.join(root, "tests", "fixtures", "scenes", "cornell_scn.scn")
    prof = os.path.join(tmp, "profile")
    png = os.path.join(tmp, "scn.png")
    zero_counters()
    rc = cli.main(["render", "--scene", scn, "--width", "512", "--height", "512", "--spp", "8",
                   "--out", png, "--profile", prof])
    launches = read_counters()
    with open(png, "rb") as f:
        check(rc == 0 and f.read(8) == b"\x89PNG\r\n\x1a\n", f"render of the .scn exited {rc}")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    k1_events = [e for e in events if "pt_pass_kernel" in str(e.get("name", ""))]
    print(f"  render --scene {os.path.relpath(scn, root)} --profile: launches {launches}; "
          f"trace of {len(events)} events, {len(k1_events)} of them K1")
    check(launches["K1"] == 1 and len(k1_events) >= 1, "the .scn render's trace holds no K1")
    res["bench"] = bench
    res["trace_events"] = len(events)
    return res


# Phase T: K3's debug taps on room and grid at the Whitted size (hit_bias 0
# and 0.005, each tap bitwise its plain version, models/whitted.whitted_taps);
# MT19937 (MT_TWISTS chained twist_torch + temper_torch blocks of each seed
# of MT_SEEDS on the card, bitwise numpy); room5's floor texture recovered
# at the example's 160x120 (examples/whitted5_texture_recovery_torch.py) for
# TEXREC_STEPS steps, and its first gradient on the card against the CPU's
# at TEXREC_GRAD_SIZE x 3/4 (one CPU gradient at 160x120 takes ~15 s).
MT_SEEDS = (0, 1, 5489, 0xF2710812)
MT_TWISTS = 1000
TEXREC = dict(size=160, lr=0.5)
TEXREC_STEPS = 5
TEXREC_GRAD_SIZE = 40
# The plain tracer's texture gradient on the card against the CPU's: the
# same float32 operations, but the card sums a texel's contributions with
# atomics in another order, and its sin/cos/exp/pow differ from the CPU's
# by ulps. Within 1e-5 of the gradient's largest texel.
TEXREC_GRAD_RTOL = 1e-5


def taps_section():
    """Phase T1: K3's tap entry (``whitted_taps_cuda``) against the plain
    version on the card, bitwise, on room and grid at 800x600 3x3 for
    hit_bias 0 and 0.005; each tap's ms on room (one call by CUDA events,
    the wrapper included; and its device time, ``queued_ms``) beside its
    bound: one nearest sweep a ray, and for ``shade`` the lights of the
    lanes that hit a non-light and their shadow tests (the plain version's
    count), at K3's op counts."""
    import torch

    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.models import whitted as W
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    w, h, ss = WHITTED["width"], WHITTED["height"], WHITTED["supersample"]
    print(f"[T1] K3's debug taps against whitted_taps on the card: {w}x{h}, {ss}x{ss}")
    o, d = W.whitted_camera_rays_device(w, h, ss, device="cuda")
    tiles = wk.rays_to_tiles(o, d)
    flat = tiles.reshape(6, -1)
    differing = {}
    zero_counters()
    for name in ("room", "grid"):
        scene = WHITTED_SCENES[name]("cuda")
        for bias in (0.0, 0.005):
            for tap in W.TAPS:
                got = wk.whitted_taps_cuda(scene, tiles, tap=tap, hit_bias=bias).reshape(3, -1).T
                plain = W.whitted_taps(scene, flat[0:3].T, flat[3:6].T, tap, bias)
                bad = int((got.view(torch.int32) != plain.view(torch.int32)).any(dim=-1).sum())
                differing[f"{name} hit_bias {bias} {tap}"] = bad
                print(f"  {name} hit_bias {bias} {tap}: {bad} of {got.shape[0]} rays differ "
                      f"in any bit; finite {bool(torch.isfinite(got).all())}")
                check(bad == 0, f"tap {tap} on {name}, hit_bias {bias}: {bad} rays differ")
    launches = read_counters()["K3"]
    check(launches == len(differing), f"{launches} K3 launches for {len(differing)} tap calls")

    scene = WHITTED_SCENES["room"]("cuda")
    rays = w * h * ss * ss
    planes = sum(1 for t in scene.ptype if t == 0)
    sweep = rays * (planes * W_OPS_PLANE + (scene.num_prims - planes) * W_OPS_SPHERE)
    work = {}
    idx, _, _, _, _ = W.whitted_shade(scene, o, d, work=work,
                                      live=torch.ones(rays, dtype=torch.bool, device="cuda"))
    is_light = torch.tensor(scene.is_light, device="cuda")
    lit = int(((idx >= 0) & ~is_light[idx.clamp(min=0)]).sum())
    shade_ops = (sweep + lit * len(scene.light_indices) * W_OPS_LIGHT
                 + work["shadow_tests"] * min(W_OPS_PLANE, W_OPS_SPHERE))
    nbytes = flat.numel() * 4 + 3 * flat.shape[1] * 4  # rays in, one triple out
    per_tap = {}
    for tap in W.TAPS:
        ms, reps = median_ms(lambda: wk.whitted_taps_cuda(scene, tiles, tap=tap))
        dev_ms, _ = queued_ms(lambda: wk.whitted_taps_cuda(scene, tiles, tap=tap), n=20)
        print(f"  tap {tap} (room, hit_bias 0): {ms:.4f} ms (reps "
              f"{['%.4f' % t for t in reps]}), {rays / ms * 1e3:.4g} rays/s; device time "
              f"{dev_ms:.4f} ms")
        bound_ms, bound_by = bound(shade_ops if tap == "shade" else sweep, nbytes, ms,
                                   f"tap {tap}")
        per_tap[tap] = {"ms": ms, "reps_ms": reps, "device_ms": dev_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                        "share_of_bound_device": bound_ms / dev_ms}
    print(f"  shade tap work: {lit} rays hit a non-light, {work['shadow_tests']} shadow tests")
    return {"differing_rays": differing, "launches": launches, "per_tap": per_tap,
            "lit_rays": lit, "shadow_tests": work["shadow_tests"]}


def mt_section():
    """Phase T2: ``twist_torch`` and ``temper_torch`` on the card, MT_TWISTS
    chained blocks from each seed of MT_SEEDS, bitwise the numpy copy
    (``_twist_np``, ``temper``); the time per tempered 624-word block."""
    import numpy as np
    import torch

    from se195_raytracer_tpu_torch.core import mt19937 as MT

    print(f"[T2] MT19937: {MT_TWISTS} chained twist_torch + temper_torch blocks on the card "
          "against numpy")
    out = {}
    for seed in MT_SEEDS:
        state = MT.seed_ref(seed).mt
        want, blocks = state, []
        for _ in range(MT_TWISTS):
            want = MT._twist_np(want)
            blocks.append(MT.temper(want))
        mt = torch.from_numpy(state.astype(np.int64)).cuda()
        got = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MT_TWISTS):
            mt = MT.twist_torch(mt)
            got.append(MT.temper_torch(mt))
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / MT_TWISTS
        same = np.array_equal(torch.stack(got).cpu().numpy(), np.stack(blocks).astype(np.int64))
        print(f"  seed {seed:#x}: bitwise numpy {same}; {ms:.4f} ms a block "
              f"({MT.N / ms * 1e3:.4g} words/s, host-bound launches)")
        check(same, f"MT19937 seed {seed:#x}: the card's blocks differ from numpy's")
        out[f"{seed:#x}"] = {"bitwise": same, "ms_per_block": ms}
    return out


def texrec_section():
    """Phase T3: examples/whitted5_texture_recovery_torch.py's recovery at
    160x120 on the card for TEXREC_STEPS steps (the loss and the seen-texel
    MAE fall), its step time, the card's idle share over one step
    (profiler), the peak memory; the first gradient on the card against the
    CPU's at TEXREC_GRAD_SIZE within TEXREC_GRAD_RTOL of its scale."""
    import importlib.util

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "whitted5_texture_recovery_torch",
        os.path.join(root, "examples", "whitted5_texture_recovery_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    size, lr = TEXREC["size"], TEXREC["lr"]
    print(f"[T3] texture recovery on the card: room5 {size}x{size * 3 // 4}, {TEXREC_STEPS} "
          f"Adam steps at lr {lr}")
    torch.cuda.reset_peak_memory_stats()
    run = ex.recover(size, TEXREC_STEPS, lr, "cuda", log=lambda line: print(f"  {line}"))
    peak = torch.cuda.max_memory_allocated()
    check(run["losses"][-1] < run["losses"][0], f"texture recovery: loss {run['losses']}")
    check(run["maes"][-1] < run["mae0"], f"texture recovery: MAE {run['mae0']} -> {run['maes']}")

    rec = ex.FloorRecovery(size, lr, "cuda")
    step_ms, step_all = host_ms(lambda: rec.step().item(), reps=3)
    for _ in range(3):  # a session that caught no device event is made again
        wall, busy, _ = device_profile(lambda: rec.step().item(), reps=1, host=False)
        if busy > 0.0:
            break
    check(busy > 0.0, "texture recovery: the profiler caught no device event")
    idle = max(0.0, 1 - busy / step_ms)
    print(f"  step {step_ms:.3f} ms (reps {['%.3f' % t for t in step_all]}; the run's "
          f"{['%.1f' % t for t in run['step_ms']]}); card busy {busy:.3f} ms a step, idle share "
          f"{idle:.2%}; peak memory {peak} B")

    grads = {}
    for dev in ("cuda", "cpu"):
        r = ex.FloorRecovery(TEXREC_GRAD_SIZE, lr, dev)
        grads[dev] = torch.autograd.grad(r.loss(), r.tex)[0].cpu().double()
    scale = grads["cpu"].abs().max().item()
    err = (grads["cuda"] - grads["cpu"]).abs().max().item()
    rel_l2 = ((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()).item()
    print(f"  first gradient at {TEXREC_GRAD_SIZE}x{TEXREC_GRAD_SIZE * 3 // 4}, card against "
          f"CPU: max |diff| {err:.4g} of scale {scale:.4g} ({err / scale:.3g}), relative L2 "
          f"{rel_l2:.3g}, bitwise {bool(torch.equal(grads['cuda'], grads['cpu']))}")
    check(err <= TEXREC_GRAD_RTOL * scale, f"texture gradient: card against CPU {err} > "
          f"{TEXREC_GRAD_RTOL} x {scale}")
    return {"size": f"{size}x{size * 3 // 4}", "steps": TEXREC_STEPS, "lr": lr,
            "losses": run["losses"], "mae0": run["mae0"], "maes": run["maes"],
            "seen_frac": run["seen_frac"], "run_step_ms": run["step_ms"], "step_ms": step_ms,
            "busy_ms": busy, "idle_share": idle, "peak_mem_bytes": peak,
            "grad_check": {"size": f"{TEXREC_GRAD_SIZE}x{TEXREC_GRAD_SIZE * 3 // 4}",
                           "max_abs_err": err, "scale": scale, "rel_l2": rel_l2,
                           "rtol": TEXREC_GRAD_RTOL}}


def phase_t():
    """Phase T: T1 (taps), T2 (MT19937), T3 (texture recovery)."""
    return taps_section(), mt_section(), texrec_section()


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--only-grad", action="store_true",
                    help="build, then run the K1 parity checks and the grad phase only "
                    "(a quick check while working on the differentiable path)")
    ap.add_argument("--only-sharded", action="store_true",
                    help="build, then run the sharded phase only (parallel/, the capacity, "
                    "session, checkpoint and CLI checks)")
    ap.add_argument("--only-t", action="store_true",
                    help="build, then run phase T only (K3's debug taps, MT19937, texture "
                    "recovery)")
    ap.add_argument("--only-seed", action="store_true",
                    help="build, then run the K1 phases (2-4) and the seed phase (4s) only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on a GPU", file=sys.stderr)
        return 1
    from se195_raytracer_tpu_torch.kernels._build import build_all, sources

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build_all(sources())
    print(f"[1] built {', '.join(sources())} in {time.perf_counter() - t0:.2f} s")
    print_ptxas(logs)

    if args.only_grad:
        print("[2] K1 against pt_pass_reference on the card")
        compare_pass(SCENE, WIDTH, HEIGHT, "pt", "mwc", "cuda")
        t = time.perf_counter()
        grad = grad_section(card)
        k1b = grad.pop("k1b_kernel")
        print(json.dumps({"grad": grad}))
        print(json.dumps({"kernels": [k1b]}))
        print(f"  (grad phase {time.perf_counter() - t:.1f} s)")
        return 0
    if args.only_sharded:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"sharded": sharded_section(tmp)}))
        print(f"  (sharded phase {time.perf_counter() - t:.1f} s)")
        return 0
    if args.only_seed:
        t = time.perf_counter()
        k1 = k1_section()
        print(json.dumps({"kernels": [k1, seed_section()]}))
        print(f"  (K1 and seed phases {time.perf_counter() - t:.1f} s)")
        return 0
    if args.only_t:
        t = time.perf_counter()
        taps, mt, texrec = phase_t()
        print(json.dumps({"taps": taps}))
        print(json.dumps({"mt19937": mt}))
        print(json.dumps({"texrec": texrec}))
        print(f"  (phase T {time.perf_counter() - t:.1f} s)")
        return 0
    t = time.perf_counter()
    kernels = [k1_section()]
    print(f"  (K1 phases {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    seed = seed_section()
    print(f"  (seed phase {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    kernels.append(k2_section())
    print(f"  (K2 phases {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    kernels.append(k3_section())
    print(f"  (K3 phases {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        k5 = k5_section(tmp)
        errs, main_launches, cells, frac, diag, k5_shares = k4_section(tmp)
    kernels.extend(w5_summary(cells, k5, errs, main_launches, frac, diag, k5_shares))
    kernels.append(seed)
    print(f"  (K4/K5 phases {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sharded = sharded_section(tmp)
    for entry in kernels:
        kernel = entry["name"].split()[0]
        entry["launches_per_sharded_render"] = sharded["launches_per_sharded_render"][kernel]
        if kernel == "K5":
            entry["sharded_launches_are"] = "K4 launches on a textured scene (K5 runs inside)"
    print(f"  (sharded phase {time.perf_counter() - t:.1f} s)")
    # The grad phase runs last: the relaxed step's profiler session still
    # holds ~25k kernels (its backward is the plain path's autograd; the hard
    # step's is K1b's one launch now), and the sessions of the earlier
    # phases, made after such a session, came back without some of their
    # events.
    t = time.perf_counter()
    grad = grad_section(card)
    k1b = grad.pop("k1b_kernel")
    k1b["launches_per_sharded_gradient"] = sharded["gradients"]["k1b_launches"]
    kernels.append(k1b)
    kernels[0]["launches_per_differentiable_forward"] = grad["forward_backward"]["spp2"][
        "k1_launches_per_forward"]
    kernels[1]["launches_per_differentiable_forward"] = grad["k2"]["k2_launches_per_forward"]
    # One seeding for the kernel forward, one for the backward's recompute.
    seed["launches_per_differentiable_step"] = 1 + grad["forward_backward"]["spp2"][
        "launches_in_backward"]["Seed"]
    print(f"  (grad phase {time.perf_counter() - t:.1f} s)")
    # Phase T after the grad phase, for the same reason: its profiler
    # session holds a gradient step's thousands of kernels.
    t = time.perf_counter()
    taps, mt, texrec = phase_t()
    kernels[2]["tap_launches"] = taps["launches"]
    kernels[2]["tap_replaces"] = ("se195_raytracer_tpu/kernels/whitted_kernel.py:128, :356-370, "
                                  ":505-532")
    kernels[2]["taps"] = taps["per_tap"]
    kernels[2]["taps_designed_in"] = designed_in("K3 taps")
    print(f"  (phase T {time.perf_counter() - t:.1f} s)")

    print(card)
    print(json.dumps({"grad": grad}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"taps": taps}))
    print(json.dumps({"mt19937": mt}))
    print(json.dumps({"texrec": texrec}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
