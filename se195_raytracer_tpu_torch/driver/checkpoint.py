"""Checkpoint and resume of progressive renders (twin of
se195_raytracer_tpu/driver/checkpoint.py).

The reference's progressive state is ``(colors[], seeds[], currentSample)``
(rendering_kernel.cl:84-89 makes any sample count a valid stopping point).
It is saved as the JAX package saves it, an npz with the keys ``kind``
(``"jnp"`` for the plain path's ``RenderState``, ``"pallas"`` for the
kernels' ``(s0, s1, acc, sample)``), ``accum``, ``s0``, ``s1`` and
``sample``. Both packages lay the kernels' lanes out alike (16 x 128
tiles, ``kernels/pt_kernel.ray_layout``), so a render checkpointed by
either package resumes in the other.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from se195_raytracer_tpu_torch.convert import pallas_state_from_numpy, pallas_state_to_numpy
from se195_raytracer_tpu_torch.core.types import resolve_device
from se195_raytracer_tpu_torch.driver.render import RenderState


def save_render_state(path: str, state: Union[RenderState, tuple]) -> None:
    """Write ``state`` (a ``RenderState`` or the kernels' state tuple) to the
    npz ``path``."""
    if isinstance(state, RenderState):
        np.savez_compressed(
            path,
            kind="jnp",
            accum=state.accum.detach().cpu().numpy(),
            s0=state.s0.cpu().numpy().astype(np.uint32),
            s1=state.s1.cpu().numpy().astype(np.uint32),
            sample=np.int32(state.sample),
        )
    else:
        s0, s1, acc, sample = pallas_state_to_numpy(state)
        np.savez_compressed(path, kind="pallas", accum=acc, s0=s0, s1=s1, sample=np.int32(sample))


def load_render_state(path: str, device=None):
    """The state saved at ``path``, of the kind that was saved, on
    ``device`` (None means CUDA, and raises without a GPU)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        accum, s0, s1, sample = z["accum"], z["s0"], z["s1"], int(z["sample"])
    if kind == "jnp":
        return RenderState(
            torch.from_numpy(np.array(accum, np.float32)).to(device),
            torch.from_numpy(np.array(s0, np.uint32)).to(device),
            torch.from_numpy(np.array(s1, np.uint32)).to(device),
            sample,
        )
    if kind != "pallas":
        raise ValueError(f"{path}: unknown state kind {kind!r}")
    return pallas_state_from_numpy(s0, s1, accum, sample, device=device)
