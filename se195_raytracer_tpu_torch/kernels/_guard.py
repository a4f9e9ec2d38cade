"""The kernel wrappers' refusal of inputs that need a gradient.

A kernel hands raw device pointers to its ``.cu`` entry point, so its
output has no autograd history, while the same wrapper on CPU tensors runs
its plain PyTorch version, which does. Without this check a render on the
card would silently give gradients of None or zero where the same call on
the CPU back-propagates. Every wrapper calls ``refuse_grad`` before it
branches on the device, so the CPU sees what the card does. Inside an
``autograd.Function``'s forward grad mode is off and the check passes.
"""

from __future__ import annotations

import dataclasses

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def refuse_grad(entry: str, *inputs) -> None:
    """Raise a RuntimeError when grad mode is on and any floating tensor in
    ``inputs`` (tensors, tuples of them, or dataclasses such as a scene)
    requires a gradient: the kernel ``entry`` would drop it."""
    if not torch.is_grad_enabled():
        return
    for t in _tensors(inputs):
        if t.requires_grad and t.is_floating_point():
            raise RuntimeError(
                f"{entry}: an input requires grad, and a kernel's output carries no "
                "autograd history. Differentiate with driver.optimize.render_differentiable "
                "(kernel forward and backward), or pass use_kernel=False to "
                "run the plain PyTorch path, or call under torch.no_grad()."
            )
