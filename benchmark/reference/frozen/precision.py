"""Matmul precision for geometry (port of `gim_tpu/utils/precision.py`).

The JAX package traces its geometry under `"highest"` matmul precision,
full float32 on the TPU's MXU. On an NVIDIA card the counterpart is TF32
off: a float32 matmul or convolution in TF32 keeps about three decimal
digits, which is wrong for DLT nullspaces, Sampson residuals and pose
decomposition. `@highp` turns both TF32 switches off around the call and
restores them afterwards. The geometry stays float32 (not float64): the
JAX package's arithmetic.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

from benchmark.reference.frozen.device import set_tf32


# the benchmark's control computes the reference in TF32 throughout,
# geometry included (`tf32_everywhere`)
_TF32 = contextvars.ContextVar("reference_tf32", default=False)


@contextlib.contextmanager
def tf32_everywhere():
    """Both TF32 switches on, and `highp` leaves them on."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    token = _TF32.set(True)
    set_tf32(True)
    try:
        yield
    finally:
        _TF32.reset(token)
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]


def highp(fn):
    """Decorator: run `fn` with both TF32 switches off (left on inside
    `tf32_everywhere`)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        set_tf32(_TF32.get())
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old[0]
            torch.backends.cudnn.allow_tf32 = old[1]

    return wrapper
