"""The full-frame gradient benchmark on the PyTorch/CUDA port (twin of
tools/grad_bench.py, which stays the JAX package's).

Cornell 512x512 inverse rendering end to end on one GPU through
``driver.optimize.render_differentiable`` (forward: the hand-written K1
kernel; backward: K1b, the hand-written backward, on a GPU, and on the CPU
autograd of the plain path recomputed from the same seeds), and the
gradient metric "pixel-grad max-err vs finite diff" (BASELINE.json) at the
same size.

The run: the target is the true Cornell scene; the start has its ceiling
light moved by (8, -5, 0) and its left wall tinted (0.3, 0.6, 0.3); the
light's and the spheres' centres and colours train with Adam per group
(centres at ``--geom-mult`` x the base rate, hard, or ``--geom-mult-soft``
x, soft), NaN gradients zeroed, each group clipped to norm 10 and its rate
decayed on a cosine to ``--sched-alpha`` of the base. It runs once with the
hard estimator and once relaxed (``--soft``), and records the loss curve,
the loss over the pixels that never see the light's disk (the part the
hard estimator can descend), the best iterate, and the light-centre and
wall-albedo errors at the best and at the final step. Then the six pixel
checks: JVP against central finite differences of the same plain forward.

Imports only the port. Writes one JSON file (``--out``).

Usage: python tools/grad_bench_torch.py [--size 512] [--spp 2] [--steps 220]
       [--out grad_bench_torch.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=220)
    ap.add_argument("--lr", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=5, help="the RNG seed (tools/grad_bench.py's)")
    ap.add_argument("--soft", type=float, default=0.5, help="the relaxed run's soft_edges")
    ap.add_argument("--geom-mult", type=float, default=10.0,
                    help="the hard run's centre rate over the base rate")
    ap.add_argument("--geom-mult-soft", type=float, default=3.0,
                    help="the relaxed run's centre rate over the base rate")
    ap.add_argument("--sched-alpha", type=float, default=0.25,
                    help="the cosine decay's floor, a fraction of the base rate")
    ap.add_argument("--interior-every", type=int, default=4,
                    help="steps between samples of the interior-masked loss")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default="grad_bench_torch.json")
    args = ap.parse_args(argv)

    import torch

    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.core.types import resolve_device
    from se195_raytracer_tpu_torch.driver import grad_check as G
    from se195_raytracer_tpu_torch.driver.optimize import (
        OptState,
        l2_image_loss,
        make_inverse_step,
        render_differentiable,
    )
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    name = card() if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp, seed=args.seed)
    spec = get_scene("cornell")
    scene_true, cam = spec.to_scene(device), spec.to_camera(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        target = render_differentiable(scene_true, cam, cfg, device=device)
    sync()
    t_target = time.perf_counter() - t0
    scene0 = G.grad_bench_start(scene_true)
    li = G.START_LIGHT
    keep = torch.from_numpy(~G.light_capsule_mask(scene_true, scene0, cam, args.size, args.size,
                                                  li)).to(device)
    mask_frac = float(1.0 - keep.float().mean())

    def errs(center, color):
        return ((center[li] - scene_true.center[li]).abs().max().item(),
                (color[G.START_WALL] - scene_true.color[G.START_WALL]).abs().max().item())

    def run_opt(opt_cfg, label, geom_mult):
        tgt = target
        if opt_cfg.soft_edges > 0.0:
            with torch.no_grad():
                tgt = render_differentiable(scene_true, cam, opt_cfg, device=device)

        def interior_loss(scene):
            with torch.no_grad():
                d2 = (render_differentiable(scene, cam, opt_cfg, device=device) - tgt) ** 2
                return (torch.mean(torch.where(keep[:, :, None], d2, 0.0))
                        / keep.float().mean()).item()

        step = make_inverse_step(
            tgt, opt_cfg,
            lambda tr: G.GroupAdam({"geom": ([tr["center"]], args.lr * geom_mult),
                                    "mat": ([tr["color"]], args.lr)},
                                   args.steps, args.sched_alpha),
            lambda n: n in ("center", "color"), device=device)
        st = OptState(scene0, cam, None, None)
        curve, secs, interior = [], [], []
        best = {"loss": float("inf"), "params": None, "step": -1}
        for i in range(args.steps):
            if i % args.interior_every == 0:
                interior.append([i, round(interior_loss(st.scene), 8)])
            before = (st.scene.center.detach().clone(), st.scene.color.detach().clone())
            sync()
            t = time.perf_counter()
            st = step(st)
            loss = float(st.loss)  # the loss at the parameters before the update
            dt = time.perf_counter() - t
            curve.append(loss)
            secs.append(round(dt, 4))
            if loss < best["loss"]:
                best = {"loss": loss, "params": before, "step": i}
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"[{label}] step {i:3d}  loss {loss:.6e}  {dt:.3f}s", flush=True)
        with torch.no_grad():
            final_loss = float(l2_image_loss(st.scene, cam, tgt, opt_cfg, device=device))
        curve.append(final_loss)
        final = (st.scene.center.detach(), st.scene.color.detach())
        if final_loss < best["loss"]:
            best = {"loss": final_loss, "params": final, "step": args.steps}
        interior.append([args.steps, round(interior_loss(st.scene), 8)])
        err_center, err_color = errs(*best["params"])
        fin_center, fin_color = errs(*final)
        print(f"[{label}] BEST step {best['step']} loss {best['loss']:.6e}  light-center err "
              f"{err_center:.4f} (was 8.0), wall-albedo err {err_color:.4f} (was 0.45); final "
              f"{fin_center:.4f} / {fin_color:.4f}", flush=True)
        return {
            "loss_curve": [round(x, 8) for x in curve],
            "interior_loss_curve": interior,
            "interior_mask_fraction": round(mask_frac, 4),
            "step_seconds": secs,
            "median_step_s": round(statistics.median(secs[1:] or secs), 4),
            "loss_first_over_best": round(curve[0] / max(best["loss"], 1e-12), 2),
            "best_step": best["step"],
            "best_loss": round(best["loss"], 8),
            "final_loss": round(final_loss, 8),
            "final_equals_best": best["step"] == args.steps,
            "recovered_at_best": {"light_center_max_err": round(err_center, 4),
                                  "wall_albedo_max_err": round(err_color, 4)},
            "recovered_at_final": {"light_center_max_err": round(fin_center, 4),
                                   "wall_albedo_max_err": round(fin_color, 4)},
        }

    hard = run_opt(cfg, "hard", args.geom_mult)
    soft = run_opt(dataclasses.replace(cfg, soft_edges=args.soft), "soft", args.geom_mult_soft)

    checks = []
    for label, param, idx, eps in G.PIXEL_CHECKS:
        for soft_w in (0.0, args.soft):
            mx, p99, scale, _ = G.pixel_grad_check(scene_true, cam, cfg, param, idx, eps, soft_w)
            checks.append({"param": label, "index": list(idx), "eps": eps, "soft_edges": soft_w,
                           "max_abs_err": mx, "p99_abs_err": p99, "fd_scale": scale,
                           "max_err_pct_of_scale": round(100.0 * mx / scale, 4)})
            print(f"pixel-grad FD check: {label} soft {soft_w}: max {mx:.3e}  p99 {p99:.3e}  "
                  f"scale {scale:.3e}  ({100.0 * mx / scale:.4f}% of scale)", flush=True)

    out = {
        "config": {"scene": "cornell", "width": args.size, "height": args.size, "spp": args.spp,
                   "seed": args.seed, "steps": args.steps, "lr": args.lr,
                   "forward": "K1 (render_differentiable, use_kernel)",
                   "backward": ("K1b (pt_backward_cuda)" if device.type == "cuda"
                                else "autograd of the remat plain path"), "device": name},
        "target_render_s": round(t_target, 3),
        "optimizer": {"schedule": f"cosine_decay(alpha={args.sched_alpha}) per group",
                      "base_lr": args.lr, "geom_lr_mult": {"hard": args.geom_mult,
                                                           "soft": args.geom_mult_soft},
                      "best_iterate_tracking": True},
        "hard": hard,
        "soft": {"soft_edges": args.soft, **soft},
        "pixel_grad_checks": checks,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
