"""The data factory's C++ chain linker (port of `gim_tpu/native/`).

`link.cpp` is the port's own copy of `gim_tpu/native/link.cpp`. It is
built with `g++` at first use into `build/gim_tpu_torch/libgimlink_
<hash>.so` at the root of the checkout (listed in `.gitignore`; the hash
covers the source and the flags), and loaded with ctypes. A failed build
raises: unlike the JAX package's loader (`gim_tpu/native/__init__.py:44,
70-72, 79`), nothing gives way to numpy. `link_numpy` is the plain
version the tests hold the compiled one against. `CALLS` counts the calls
of each version, so a caller can say which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "link.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "gim_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
CALLS = {"compiled": 0, "numpy": 0}
_LIB: list[ctypes.CDLL] = []


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgimlink_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """The compiled linker, built first if needed; raises if g++ fails."""
    if _LIB:
        return _LIB[0]
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.gim_link.restype = ctypes.c_longlong
    lib.gim_link.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
    ]
    _LIB.append(lib)
    return lib


def link_numpy(label0: np.ndarray, label1: np.ndarray,
               width: int) -> np.ndarray:
    """The plain version: the semantics of walk.create_table / link
    (`gim_tpu/native/__init__.py:50-65`)."""
    CALLS["numpy"] += 1
    k0 = np.round(label0[:, 2]) + np.round(label0[:, 3]) * width
    k1 = np.round(label1[:, 0]) + np.round(label1[:, 1]) * width
    t0 = dict(zip(k0.tolist(), range(len(k0))))
    t1 = dict(zip(k1.tolist(), range(len(k1))))
    keys = t0.keys() & t1.keys()
    if not keys:
        return np.zeros((0, 4), np.float32)
    i = np.array([t0[k] for k in keys])
    j = np.array([t1[k] for k in keys])
    ij = np.unique(np.stack([i, j]), axis=1)
    return np.concatenate([label0[ij[0], :2], label1[ij[1], 2:]],
                          axis=1).astype(np.float32)


def link_fast(label0: np.ndarray, label1: np.ndarray,
              width: int) -> np.ndarray:
    """Chain (N, 4) and (M, 4) label sets through exact middle-pixel
    matches, in the compiled linker."""
    label0 = np.ascontiguousarray(label0, np.float32)
    label1 = np.ascontiguousarray(label1, np.float32)
    lib = load_library()
    CALLS["compiled"] += 1
    max_out = min(len(label0), len(label1))
    out = np.empty((max(max_out, 1), 4), np.float32)

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    n = lib.gim_link(fptr(label0), len(label0), fptr(label1), len(label1),
                     int(width), fptr(out), max_out)
    if n < 0:
        raise RuntimeError("gim_link: more chains than the smaller label set")
    return out[:n].copy()
