"""Times only the device-side Whitted trace of K3 (the port's twin of
tools/whitted_device_probe.py): the camera rays of an 800x600 3x3 frame are
made once and stay on the card, so the time is the explicit-ray entry's
alone, without host ray generation or copies.

    python3 tools/whitted_device_probe_torch.py [SCENE] [--tap tres|attr|shade]

SCENE is a Whitted scene name (default room). ``--tap`` also times the
debug-tap entry on the same rays. Times are CUDA events around one launch,
the best of 5 after a warm-up; the card's name and power limit are printed
beside them. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def best_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(argv=None) -> int:
    import torch

    from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
    from se195_raytracer_tpu_torch.models.whitted import TAPS, whitted_camera_rays_device
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="room", choices=sorted(WHITTED_SCENES))
    ap.add_argument("--tap", choices=TAPS, default=None, help="also time this debug tap")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    scene = WHITTED_SCENES[args.scene]("cuda")
    w, h, ss = 800, 600, 3
    rays = wk.rays_to_tiles(*whitted_camera_rays_device(w, h, ss, device="cuda"))
    r = w * h * ss * ss
    ms = best_ms(lambda: wk.whitted_trace_cuda(scene, rays, trace_depth=5))
    print(f"device-only trace ({args.scene} {w}x{h} {ss}x{ss}, depth 5): {ms:.4f} ms  "
          f"{r / ms / 1e3:.2f} Mrays/s  [{card}]")
    if args.tap:
        ms = best_ms(lambda: wk.whitted_taps_cuda(scene, rays, tap=args.tap))
        print(f"device-only tap {args.tap!r}: {ms:.4f} ms  {r / ms / 1e3:.2f} Mrays/s  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
