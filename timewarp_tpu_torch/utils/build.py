"""Build the port's CUDA kernels and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Nothing outside the repo is
compiled. The libraries go to ``build/timewarp_tpu_torch/`` beside the
package, named by a digest of source, the shared ``csrc/*.cuh`` headers
and flags, so an edited source is rebuilt and an unchanged one reused. All sources build in parallel, one
``nvcc`` each, at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "BUILD_DIR", "BuildRecord", "build_all", "library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "timewarp_tpu_torch"
#: the kernel sources, one library each
SOURCES = ("fire_compact", "mailbox_insert", "sample_insert", "fused_ring")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildRecord:
    """One library: where it is, how long its ``nvcc`` took (0 when it
    was already built), and what ``ptxas -v`` reported."""
    path: Path
    seconds: float
    ptxas: str


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of timewarp_tpu_torch build at first use on a machine with "
            "the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, BuildRecord]:
    """Build every missing library, all ``nvcc`` processes started
    together; raise with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    records, procs = {}, {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            records[name] = BuildRecord(out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        records[name] = BuildRecord(out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return records


_LOADED: Dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name].path))
        _LOADED[name] = lib
    return lib
