"""The reference of an inverse-rendering job's first steps, and the numbers
that compare the program's with it.

``follow`` renders the target from the true scene, then takes the steps
from the start: the L2 loss of a render of the current scene against the
target, its gradient by autograd (pass by pass, in blocks of pixels, so
that it fits), and per group of leaves optax's ``chain(zero_nans, clip_by_global_norm,
adam(cosine_decay_schedule))`` written out in plain tensor arithmetic as
``torch.optim.Adam`` computes it (b1 0.9, b2 0.999, eps 1e-8 outside the
root, bias-corrected).

``compare`` takes each number by its worst case: the loss of each step
relative to the reference's, and for the first gradient and the change of
the parameters after the steps, the gap between the program's and the
reference's norm of each trainable leaf (the spheres' centres, their
colours), measured against that leaf's reference norm or the median
leaf's, whichever is larger. A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out
of the change.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference import smallpt as ref

LEAVES = ("center", "color")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
DEAD_LEAF = 1e-3


def start_arrays(arrays: dict, start: dict) -> dict:
    """The job's start: sphere ``light`` moved by ``light_move``, sphere
    ``wall`` coloured ``wall_color``."""
    out = {k: v.copy() for k, v in arrays.items()}
    out["center"][start["light"]] += np.asarray(start["light_move"], np.float32)
    out["color"][start["wall"]] = np.asarray(start["wall_color"], np.float32)
    return out


def rate_factor(count: int, steps: int, alpha: float) -> float:
    c = min(count, steps)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps)) + alpha


def pass_weights(spp: int) -> List[float]:
    """d(final running mean) / d(pass k's sample), as autograd takes it
    through the kernels' running mean in float32."""
    acc = torch.zeros(1)
    rs = [torch.zeros(1, requires_grad=True) for _ in range(spp)]
    for k, r in enumerate(rs):
        acc = ref.accumulate(acc, r, k, "reciprocal")
    return [float(g) for g in torch.autograd.grad(acc.sum(), rs)]


def follow(arrays: dict, start: dict, cam, frame: ref.Frame, target_seed: int,
           step_seeds: Sequence[int], traffic: dict, device, dtype=torch.float32,
           fault: Optional[str] = None) -> dict:
    """{"loss": [each step's loss], "grad": [the first step's clipped
    gradient per leaf], "params": [the leaves after the steps], "start":
    [the leaves at the start]} (on the host). Each step's frame is rendered
    once without a graph, keeping each pass's RNG words; then each pass is
    rendered again with the graph, in blocks of pixels, and takes its share
    of the loss's cotangent. ``fault="half"`` takes the loss over the first
    half of the frame's rows only (a check of the comparison, never the
    reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = traffic["optimizer"]
    block = traffic["check"]["block"]
    n = frame.width * frame.height
    rows = n if fault != "half" else (frame.height // 2) * frame.width
    pixels = ref.all_pixels(frame, device)[:rows]
    blocks = [pixels[a:a + block] for a in range(0, rows, block)]
    o, t = (torch.tensor(v, device=device).to(dtype) for v in cam)
    basis = ref.camera_basis(o, t, frame.width, frame.height)
    with torch.no_grad():
        target = ref.render_pixels(ref.make_scene(arrays, device, dtype), basis, frame,
                                   target_seed, pixels, dtype=dtype, block=block)
    weights = pass_weights(frame.spp)
    base = ref.make_scene(start, device, dtype)
    params = [getattr(base, k).detach().clone() for k in LEAVES]
    lrs = [opt["lr"] * opt["geom_mult"], opt["lr"]]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses: List[float] = []
    first = None
    for step, seed in enumerate(step_seeds):
        words = ref.seeds(seed, n)
        with torch.no_grad():
            scene = base._replace(center=params[0], color=params[1])
            img, states = [], []
            for pix in blocks:
                s0, s1 = ref.pixel_words(words, pix)
                acc = torch.zeros((pix.shape[0], 3), dtype=dtype, device=device)
                kept = []
                for k in range(frame.spp):
                    kept.append((s0, s1))
                    rad, s0, s1 = ref.one_pass(scene, basis, frame, pix, s0, s1, dtype)
                    acc = ref.accumulate(acc, rad, k, "reciprocal")
                img.append(acc)
                states.append(kept)
            img = torch.cat(img)
            losses.append(float(torch.mean((img - target) ** 2)))
            cot = 2.0 * (img - target) / (rows * 3)
        leaves = [p.clone().requires_grad_(True) for p in params]
        scene = base._replace(center=leaves[0], color=leaves[1])
        a = 0
        for pix, kept in zip(blocks, states):
            c = cot[a:a + pix.shape[0]]
            a += pix.shape[0]
            for k, (s0, s1) in enumerate(kept):
                rad = ref.one_pass(scene, basis, frame, pix, s0, s1, dtype)[0]
                (rad * (c * weights[k])).sum().backward()
        grads = []
        for p in leaves:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = torch.where(torch.isnan(g), 0.0, g).to(dtype)
            norm = torch.sqrt(torch.sum(g * g))
            grads.append(g * torch.where(norm < opt["max_norm"], 1.0, opt["max_norm"] / norm))
        if first is None:
            first = [g.detach().float().cpu() for g in grads]
        factor = rate_factor(step, traffic["restart_every"], opt["sched_alpha"])
        t_ = step + 1
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = m[i] + (g - m[i]) * (1.0 - BETA1)
                v[i] = v[i] * BETA2 + g * g * (1.0 - BETA2)
                step_size = lrs[i] * factor / (1.0 - BETA1 ** t_)
                denom = torch.sqrt(v[i]) / math.sqrt(1.0 - BETA2 ** t_) + EPS
                params[i] = params[i] - step_size * (m[i] / denom)
    return {"loss": losses, "grad": first, "params": [p.float().cpu() for p in params],
            "start": [torch.tensor(start[k]) for k in LEAVES]}


def _leaf_norms(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in tensors])


def _worst(got: np.ndarray, want: np.ndarray, keep: Optional[np.ndarray] = None) -> float:
    """The worst leaf's |got - want| over its reference norm or the median
    leaf's, whichever is larger."""
    if keep is not None:
        got, want = got[keep], want[keep]
    if got.size == 0:
        return 0.0
    if not np.all(np.isfinite(got)):
        return float("inf")
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    scale = np.where(scale > 0.0, scale, 1.0)
    return float(np.max(np.abs(got - want) / scale))


def compare(program: dict, reference: dict) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap (the module's docstring)."""
    lp, lr = np.array(program["loss"], np.float64), np.array(reference["loss"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr))) if np.all(np.isfinite(lp)) else \
        float("inf")
    gp, gr = _leaf_norms(program["grad"]), _leaf_norms(reference["grad"])
    start = reference["start"]
    dp = _leaf_norms([a - s for a, s in zip(program["params"], start)])
    dr = _leaf_norms([a - s for a, s in zip(reference["params"], start)])
    keep = gr >= DEAD_LEAF * np.median(gr)
    return {"loss_gap": loss_gap, "grad_gap": _worst(gp, gr), "change_gap": _worst(dp, dr, keep)}
