"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source `gim_tpu_torch/csrc/<name>.cu` has a plain C interface and is
compiled by `nvcc` for `sm_90a` into `build/gim_tpu_torch/lib<name>_
<hash>.so` at the root of the checkout (listed in `.gitignore`). The hash
covers the source, the `csrc/` headers it includes (`hopper.cuh`) and the
flags, so an unchanged source is not rebuilt and an edited header is.
Nothing here runs when a module is imported: the CPU tests import every
module on a host without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "gim_tpu_torch"
SOURCES = ("dsmax", "refiner", "flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME (as PyTorch's extension builder finds it) or
    PATH; raises if there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _inputs(name: str) -> list[Path]:
    """csrc/<name>.cu and the csrc headers it includes (`#include "x"`)."""
    src = CSRC / f"{name}.cu"
    heads = re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)
    return [src, *(CSRC / h for h in heads)]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _inputs(name):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc for each,
    all started together. Returns each build's compiler output ("" when
    the library was already built); raises if a build fails."""
    started = {n: _start_build(n) for n in names}
    logs = {}
    for n, job in started.items():
        if job is None:
            logs[n] = ""
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
        os.replace(tmp, out)
        logs[n] = log
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
