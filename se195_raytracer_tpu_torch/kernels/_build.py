"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``se195_raytracer_tpu_torch/_build/`` (listed
in .gitignore), then loaded with ``ctypes``. The first ``load`` builds every
source, one ``nvcc`` each, all started together. The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time: the
CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# Never --use_fast_math: it approximates sinf/cosf/sqrtf/division and
# flushes denormals, which breaks parity with the plain version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Per-source flags. K3 and K4 round every a * b + c twice, as their plain
# versions' separate tensor ops do, so that the two agree to the ulp on the
# geometry. K1b needs no flag: its replay rounds each product and sum with
# intrinsics that are never contracted, and its reverse sweep may contract.
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "whitted_kernel": ("-fmad=false",),
    "whitted5_kernel": ("-fmad=false",),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources() -> Tuple[str, ...]:
    """The name of every ``csrc/*.cu``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _source_bytes(name: str) -> bytes:
    """The source's bytes and those of the csrc/ files it ``#include``s."""
    text = (CSRC / f"{name}.cu").read_bytes()
    local = re.findall(rb'^#include "([^"]+)"', text, flags=re.M)
    return text + b"".join((CSRC / inc.decode()).read_bytes() for inc in local)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source_bytes(name) + " ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns each source's compiler log
    (ptxas register and shared-memory report; empty when already built).
    Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
    logs: Dict[str, str] = {}
    nvcc = None
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``; the first call builds
    every source that has no current library."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all(sources())
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
