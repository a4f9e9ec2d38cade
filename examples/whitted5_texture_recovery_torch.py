"""Inverse texture recovery through the whitted5 renderer, in the PyTorch
port (twin of examples/whitted5_texture_recovery.py).

The port's plain whitted5 tracer is differentiable dataflow (the texture
bitmaps are tensors of ``Whitted5Scene``), so the bilinear texel fetch
(Texture::GetTexel, raytracer5/trunk/scene.cpp:81-106) differentiates:
d(image)/d(texel) flows through the bilinear weights to exactly the texels
the camera sees. This example recovers the checker floor texture from a
rendered target, starting from flat grey, with Adam (``torch.optim.Adam``
is optax's adam). It renders with ``use_kernel=False``: K4 has no backward,
and the JAX example differentiates its plain tracer too.

Usage: python examples/whitted5_texture_recovery_torch.py
       [--size 160] [--steps 40] [--lr 0.5] [--out-prefix /tmp/texrec]
       [--device cuda|cpu]

The default device is the CUDA device; ``--device cpu`` runs on the CPU.
Prints the lines of the JAX example, each step line with its time, then
the median step time and, on a GPU, the peak memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class FloorRecovery:
    """room5's floor texture as the one trainable tensor, from flat grey
    towards the render of the true scene at ``size`` x ``size * 3 // 4``,
    spp 1, with Adam at ``lr``."""

    def __init__(self, size: int = 160, lr: float = 0.5, device=None):
        import torch

        from se195_raytracer_tpu_torch.core.types import resolve_device
        from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene

        self.device = resolve_device(device)
        self.width, self.height = size, size * 3 // 4
        self.scene = room5_scene(device=self.device)
        with torch.no_grad():
            self.target = self.render(self.scene.textures[0])
        # Start: a flat grey floor texture (the marble sphere keeps its true
        # texture; the floor is the optimization target).
        self.tex0 = self.scene.textures[0]
        self.tex = torch.full_like(self.tex0, 0.5).requires_grad_(True)
        self.opt = torch.optim.Adam([self.tex], lr=lr)

    def render(self, tex):
        from se195_raytracer_tpu_torch.models.whitted5 import render_whitted5

        scene = dataclasses.replace(self.scene, textures=(tex,) + self.scene.textures[1:])
        return render_whitted5(scene, width=self.width, height=self.height, spp=1,
                               use_kernel=False, device=self.device)

    def loss(self):
        import torch

        return torch.mean((self.render(self.tex) - self.target) ** 2)

    def step(self):
        """One Adam step; returns the loss before it (on the device)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def mae(self, tex, seen) -> float:
        """Mean |tex - true texture| over the ``seen`` texels."""
        import numpy as np

        return float(np.abs((tex.detach() - self.tex0).cpu().numpy())[seen].mean())


def recover(size: int = 160, steps: int = 40, lr: float = 0.5, device=None, log=print) -> dict:
    """``steps`` Adam steps of ``FloorRecovery``. The "seen" texels are those
    with a nonzero gradient at the start (the camera never samples the
    others). Returns the loss before each update, the seen-texel MAE at the
    start and after each update, the step times (host clock, synchronised),
    the first gradient, the share of texels seen, and the true and recovered
    textures (the last four on the CPU)."""
    import torch

    log(f"rendering {size}x{size * 3 // 4} target...")
    rec = FloorRecovery(size, lr, device)
    sync = torch.cuda.synchronize if rec.device.type == "cuda" else (lambda: None)
    gray = rec.tex.detach().clone()
    losses, maes, step_ms, seen, g0 = [], [], [], None, None
    for i in range(steps):
        sync()
        t = time.perf_counter()
        losses.append(rec.step().item())  # synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
        if seen is None:
            g0 = rec.tex.grad.detach().cpu()
            seen = (g0.abs().sum(-1) > 0).numpy()
            log(f"{seen.mean() * 100:.1f}% of floor texels are camera-visible")
        maes.append(rec.mae(rec.tex, seen))
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {losses[-1]:.6e}  seen-texel MAE {maes[-1]:.4f}  "
                f"{step_ms[-1]:.1f} ms")
    return {"losses": losses, "mae0": rec.mae(gray, seen), "maes": maes, "step_ms": step_ms,
            "grad0": g0, "seen_frac": float(seen.mean()), "true": rec.tex0.cpu(),
            "recovered": rec.tex.detach().cpu(), "device": str(rec.device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--out-prefix", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1: the seen texels come from the first gradient")

    import numpy as np
    import torch

    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    out = recover(args.size, args.steps, args.lr, args.device, log=lambda s: print(s, flush=True))
    err0, err1 = out["mae0"], out["maes"][-1]
    print(f"seen-texel MAE: {err0:.4f} -> {err1:.4f} "
          f"({err0 / max(err1, 1e-9):.1f}x better)", flush=True)
    print(f"step time: median {statistics.median(out['step_ms']):.1f} ms over {args.steps} steps "
          f"on {out['device']}", flush=True)
    if out["device"].startswith("cuda"):
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        print(f"peak memory allocated: {out['peak_mem_bytes']} B "
              f"({torch.cuda.get_device_name(0)})", flush=True)

    if args.out_prefix:
        from se195_raytracer_tpu_torch.io.image import write_image

        for name in ("true", "recovered"):
            img = np.clip(out[name].numpy() * 255.0, 0, 255).astype(np.uint8)
            write_image(img, f"{args.out_prefix}_{name}.png")
            print(f"wrote {args.out_prefix}_{name}.png", flush=True)
    return out


if __name__ == "__main__":
    main()
