"""What the CPU can check of K1b's source and build (csrc/pt_backward_kernel.cu,
kernels/_build.py, kernels/pt_backward_kernel.py); the kernel itself runs
only on the card.

- Each fault that ``tools/k1b_fault_check.py`` plants is a one-line edit
  found by a search string: each string occurs exactly once in the source,
  so an edit of the source cannot leave a fault unplanted (the tool checks
  this only on the card, when it runs).
- ``tools/k1b_split.py`` matches the source to the design whose variant
  edits all apply.
- The launch constants of the Python mirror of K1b's route are the
  source's.
- K1b is built without ``-fmad=false`` (its replay rounds with intrinsics
  that are never contracted; its reverse sweep may contract), the Whitted
  kernels keep it, and no source is built with ``--use_fast_math``.
- The running-mean weights a backward hands the kernel, cached per (spp,
  device), are ``running_mean_weights(spp)`` bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.kernels import _build
from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as K

ROOT = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "pt_backward_kernel.cu"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FAULTS = _tool("k1b_fault_check").FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_line_occurs_once(fault):
    """The fault's search string is in K1b's source exactly once."""
    old, new = FAULTS[fault]
    text = SOURCE.read_text()
    assert text.count(old) == 1, (fault, old)
    assert old != new


def test_split_knows_the_current_design():
    """``tools/k1b_split.py`` finds every variant's search strings in the
    checkout's source (the lockstep design with per-lane columns), each
    exactly once."""
    split = _tool("k1b_split")
    assert split.design_of(str(ROOT)) == "lane columns"


@pytest.mark.parametrize("name,value", [("kThreads", K.THREADS), ("kMinBlocks", K.MIN_BLOCKS),
                                        ("kRows", K.SCENE_ROWS)])
def test_source_constants_are_the_route_mirrors(name, value):
    """The launch constants that ``k1b_lane_columns`` and
    ``k1b_shared_memory_bytes`` mirror are the source's."""
    assert f"constexpr int {name} = {value};" in SOURCE.read_text()


def test_k1b_builds_without_fmad_false():
    """K1b's flags carry no ``-fmad=false``; K3's and K4's do; no source
    takes ``--use_fast_math``."""
    assert "-fmad=false" not in _build.flags("pt_backward_kernel")
    for name in ("whitted_kernel", "whitted5_kernel"):
        assert "-fmad=false" in _build.flags(name), name
    for name in _build.sources():
        assert not any("fast_math" in f for f in _build.flags(name)), name


@pytest.mark.parametrize("spp", range(1, 9))
def test_cached_weights_are_the_running_mean_weights(spp):
    """The cached tensor holds ``running_mean_weights(spp)`` bitwise, float32,
    and a second call hands back the same tensor."""
    w = K.running_mean_weights_tensor(spp, "cpu")
    want = np.asarray(K.running_mean_weights(spp), dtype=np.float32)
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    assert np.array_equal(w.numpy().view(np.uint32), want.view(np.uint32))
    assert K.running_mean_weights_tensor(spp, torch.device("cpu")) is w
