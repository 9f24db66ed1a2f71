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
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "gim_tpu_torch"
SOURCES = ("dsmax", "refiner", "flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[tuple, ctypes.CDLL] = {}


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


def _inputs(name: str, csrc: Path | None = None) -> list[Path]:
    """<csrc>/<name>.cu and the headers it includes (`#include "x"`)."""
    csrc = csrc or CSRC
    src = csrc / f"{name}.cu"
    heads = re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)
    return [src, *(csrc / h for h in heads)]


def library_path(name: str, csrc: Path | None = None,
                 flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for f in _inputs(name, csrc):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str, csrc: Path | None,
                 flags: tuple[str, ...]) -> tuple[subprocess.Popen, Path,
                                                  Path] | None:
    out = library_path(name, csrc, flags)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique per process and thread: variants with one source build apart
    tmp = out.with_name(
        f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
           str((csrc or CSRC) / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES, csrc: Path | None = None,
              flags: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc for each,
    all started together. Returns each build's compiler output ("" when
    the library was already built); raises if a build fails. `csrc` and
    `flags` build another source directory or with extra nvcc flags (a
    variant, as `f32_probe.py` builds them)."""
    started = {n: _start_build(n, csrc, flags) for n in names}
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


def load_library(name: str, csrc: Path | None = None,
                 flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (or a variant: `build_all`),
    built first if needed."""
    key = (name, str(csrc), flags)
    lib = _LIBS.get(key)
    if lib is None:
        build_all((name,), csrc, flags)
        lib = ctypes.CDLL(str(library_path(name, csrc, flags)))
        _LIBS[key] = lib
    return lib
