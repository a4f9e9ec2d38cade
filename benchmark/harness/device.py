"""The ``device`` field of a result."""

from __future__ import annotations


def describe(device: str, count: int, peak_bytes: int) -> dict:
    """platform, kind (``torch.cuda.get_device_name``), the cards the cell
    uses and the peak of device memory allocated on the fullest one."""
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak_bytes}
