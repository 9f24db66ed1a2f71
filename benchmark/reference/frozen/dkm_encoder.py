"""torchvision-layout ResNet-50 feature pyramid for gim_dkm (PyTorch port).

Port of `gim_tpu/models/dkm/encoder.py:51-86` (`ResNet50Pyramid`;
reference networks/dkm/models/encoders.py:30-70): the full ResNet-50 (7x7/2
stem, 3x3/2 maxpool, layer1..4, no `fc`) under `net.`, returning the
features at strides {1, 2, 4, 8, 16, 32}. BatchNorm is frozen (running
statistics; the reference's freeze_bn). The parameters stay float32 and
each layer computes in the configured dtype (`models/resnet.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.frozen.resnet import ResNet50
from benchmark.reference.frozen.device import torch_dtype


class ResNet50Pyramid(nn.Module):
    def __init__(self, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.net = ResNet50(num_layers=4, maxpool=True)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        """x: (B, 3, H, W). Returns {stride: (B, C, H', W')} in the compute
        dtype: 1 (the input, 3 channels), 2 (64), 4 (256), 8 (512), 16
        (1024), 32 (2048)."""
        x = x.to(self.dtype)
        return dict(zip((1, 2, 4, 8, 16, 32), [x, *self.net(x)]))
