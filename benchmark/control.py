"""The readings that the check's limits are set from, on the card, at a
cell's own size, in one process.

    python3 benchmark/control.py --workload <name> --seeds 12 --control-seeds 3 \
        [--seconds 1] [--out chiprun_out/control.json]

For each of ``--seeds`` fresh seeds, the program's sound reading: the
cell's driver sets up, runs a short window at the cell's own load (none for
an inverse-rendering job, whose readings are its first steps) and is
checked as a run is. For ``--control-seeds`` of them, the control: the
reference in the program's place, computed in bfloat16, the precision
below the float32 the configuration states. Besides, the faults a run can
have, each in the reference put in the program's place: for renders, half
of the samples a pixel (the mean over the rest), a seed one off (an answer
altered where it is made) and an image left as it started (zeros); for an
inverse-rendering job, the loss over half of the frame's rows, and a state
left unchanged (parameters at the start). Prints one JSON object and
writes it to ``--out``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def render_readings(job, control: bool) -> dict:
    import torch

    from reference import smallpt as ref

    out = {"sound": 0.0}
    for seed, pixels, got in job.samples():
        want = job.reference_pixels(seed, pixels)
        out["sound"] = max(out["sound"], ref.image_gap(got, want))
        if not control:
            continue
        faults = {
            "bfloat16": job.reference_pixels(seed, pixels, dtype=torch.bfloat16),
            "seed_off_by_one": job.reference_pixels(seed + 1, pixels),
            "unchanged": torch.zeros_like(want),
        }
        half = job.frame.spp // 2
        frame = job.frame
        job.frame = frame._replace(spp=half)
        try:
            faults["half_samples"] = job.reference_pixels(seed, pixels)
        finally:
            job.frame = frame
        for k, v in faults.items():
            out[k] = max(out.get(k, 0.0), ref.image_gap(v, want))
    return out


def grad_readings(job, control: bool) -> dict:
    import torch

    from reference import inverse

    want = job.reference_run()
    out = {f"sound.{k}": v for k, v in inverse.compare(job.readings, want).items()}
    if control:
        faults = {"bfloat16": job.reference_run(dtype=torch.bfloat16),
                  "half_rows": job.reference_run(fault="half"),
                  "unchanged": {**job.readings, "params": want["start"]}}
        for name, got in faults.items():
            out.update({f"{name}.{k}": v for k, v in inverse.compare(got, want).items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default="{}",
                    help="JSON of traffic keys to replace (a small frame for a CPU test)")
    args = ap.parse_args(argv)

    import torch

    from harness.manifest import Manifest
    from harness.trace import Spans

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    man = Manifest()
    cell = man.cell(args.workload)
    config = man.config(cell)
    traffic = {**man.traffic(cell), **json.loads(args.override)}
    driver = man.driver(traffic)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        job = driver.Job(config, traffic, seed, torch.device(args.device))
        job.setup()
        if traffic["kind"] == "inverse_step":
            job.first_in_window = job.steps
            job.release()
            reading = grad_readings(job, i < args.control_seeds)
        else:
            job.window(args.seconds, Spans())
            job.release()
            reading = render_readings(job, i < args.control_seeds)
        reading.update(seed=seed, attempted=job.attempted, seconds=time.perf_counter() - t0)
        rows.append(reading)
        print(json.dumps(reading), flush=True)
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0)
              if args.device == "cuda" else "cpu", "limits": traffic["limits"], "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
