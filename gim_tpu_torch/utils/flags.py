"""The port's kernel switches, read at call time in this one place.

Same names, defaults and meanings as the JAX package (`docs/FLAGS.md`):

- `GIM_TPU_FUSED_REFINER` (default "0"): the ConvRefiner's hidden blocks
  run as the fused kernel K2 (`ops/kernels/refiner.py`) where
  `models/dkm/blocks.py:ConvRefiner` allows it (depthwise, inference,
  hidden_dim <= 192);
- `GIM_TPU_FLASH_VIT` (default "0"): every ViT attention (DINOv2 and the
  RoMa coordinate decoder) runs as the flash kernel K3
  (`ops/kernels/flash.py`).

"1" and "force" switch a kernel on; anything else leaves the default
graph (plain convolutions, plain `sdpa`). With a switch on, a CUDA tensor
launches the kernel or raises, and a CPU tensor takes the kernel's plain
version.
"""

from __future__ import annotations

import os

ON = ("1", "force")


def fused_refiner() -> bool:
    return os.environ.get("GIM_TPU_FUSED_REFINER", "0") in ON


def flash_vit() -> bool:
    return os.environ.get("GIM_TPU_FLASH_VIT", "0") in ON
