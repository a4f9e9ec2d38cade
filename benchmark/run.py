"""Run one cell of the benchmark of se195_raytracer_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It needs as many CUDA cards as the cell asks
for, and exits non-zero with no result without them. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checked``: each number the check compared, with
its limit (also the last lines of standard error).

The program's build and kernel caches stay inside the checkout, at fixed
paths: its kernels build into ``se195_raytracer_tpu_torch/_build/``,
torch's extensions and Triton's cache go under ``.bench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness.manifest import Manifest
    from harness.runner import emit, run_cell

    import se195_raytracer_tpu_torch as port

    if Path(port.__file__).resolve().parents[1] != ROOT:
        print(f"the program under test must be this checkout's ({ROOT}); "
              f"found {port.__file__}", file=sys.stderr)
        return 2
    man = Manifest()
    chips = man.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                      t_start=T_START, manifest=man)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
