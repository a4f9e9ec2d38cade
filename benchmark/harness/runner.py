"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` is what ``run.py`` calls once it has found the cards the cell
asks for; the CPU rehearsal test calls it with ``device="cpu"`` and a tiny
frame. Order of a run: the driver's set-up (the program's kernels loaded
from their build, the scene on the device, the cell's own shapes warmed)
ends ``setup_s``; the window runs for ``seconds`` (under the profiler with
``trace``); the peak memory is read; the program's state is freed; then the
reference checks what the window produced, and the per-layer readers read
the spans and the trace.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict, Optional

import numpy as np

from harness import device as devinfo
from harness.manifest import Manifest
from harness.trace import Spans, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "se195_raytracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``se195_raytracer_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def _guard() -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"the process holds {found}: the benchmark measures the "
                              "PyTorch port alone")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, overrides: Optional[Dict] = None,
             manifest: Optional[Manifest] = None) -> dict:
    """Run ``workload`` once and return the result object (the line's
    content). ``overrides`` replace keys of the traffic mix (the rehearsal's
    tiny frame)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest or Manifest()
    cell = man.cell(workload)
    config = man.config(cell)
    traffic = {**man.traffic(cell), **(overrides or {})}
    driver = man.driver(traffic)
    cuda = torch.device(device).type == "cuda"

    job = driver.Job(config, traffic, seed, torch.device(device))
    t_job = time.perf_counter()
    job.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"setup_s {setup_s:.3f}: to the driver {t_job - t_start:.3f}, its set-up "
          f"{setup_s - (t_job - t_start):.3f}", file=sys.stderr)
    spans = Spans(traced=trace)
    tracer = Tracer(trace, cuda)
    with tracer.window():
        job.window(seconds, spans)
    _guard()
    if getattr(job, "times", None):
        q = np.percentile(np.array(job.times) * 1e3, [0, 25, 50, 75, 95, 99, 100])
        print("ms a unit, min q1 median q3 p95 p99 max: " + " ".join(f"{x:.4f}" for x in q),
              file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    reduced = tracer.reduce()
    job.release()
    t_check = time.perf_counter()
    correct, checked = job.check()
    print(f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    if trace:
        metrics = {}
        for m in man.per_layer_for(workload):
            value = man.metric_reader(m["name"]).read(job, spans, reduced, man)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = job.end_to_end()
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in man.end_to_end_for(workload)}
    dev = devinfo.describe(device, cell["chips"], peak)
    result = {"correct": bool(correct), "attempted": job.attempted, "failed": job.failed,
              "metrics": metrics, "device": dev}
    if trace and reduced is not None:
        dev["busy_s"] = reduced.busy_s()
        dev["window_s"] = reduced.window_s
        result["breakdown"] = {"device_ops": reduced.device_ops(),
                               "idle_gaps": reduced.idle_gaps()}
    result["checked"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checked.items()}
    _guard()
    return result


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error; the result as the last line of standard output."""
    for k, c in result["checked"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False))
    sys.stdout.flush()


def _finite(x):
    """``x`` with every non-finite float written as a string, so that the
    line is strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
