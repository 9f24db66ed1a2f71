"""Device resolution and float32 precision settings.

Counterpart of the JAX package's backend selection (`gim_tpu/utils/
precision.py` covers its matmul precision). Entry points of the port run
on the GPU unless the caller asks for the CPU, and never fall back.

Precision. On an NVIDIA card PyTorch runs a float32 matmul in full float32
by default, but a float32 convolution goes through cuDNN in TF32 (about
three decimal digits). `set_tf32` sets both switches explicitly; the
matchers turn both off, so their float32 path is float32 end to end. The
bfloat16 path (`LoFTRConfig.dtype="bfloat16"`) stores weights and
activations in bf16 and runs convolutions and matmuls on the tensor cores
with float32 accumulation; the TF32 switches do not touch it.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to run on: CUDA unless the caller names the CPU.

    Raises if CUDA is asked for and absent: the port has no silent CPU
    fallback, so a timing or a result always names the device it ran on.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_tf32(enabled: bool) -> None:
    """Set both TF32 switches (matmul and cuDNN convolution) together."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


_CONSTANTS: dict = {}


def device_constant(name: str, value, device) -> torch.Tensor:
    """The numpy constant `value` on `device`, copied there once per
    (name, device): a host-to-device copy from pageable memory waits for
    the stream, so a constant copied on every call would sync the host."""
    key = (name, str(torch.device(device)))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(value).to(device)
    return _CONSTANTS[key]


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; choose from "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]
