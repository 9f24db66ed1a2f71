"""ResNet-50 bottleneck FPN backbone for gim_loftr (1/8 + 1/2 features).

Port of `gim_tpu/models/loftr/backbone.py` (reference: GIM's RGB ResNet-50
variant, ref networks/loftr/backbone/resnet.py:247-329 — Bottleneck
[3,4,6,3], 7x7/2 stem, NO maxpool, truncated after layer3). FPN heads:
1x1 lateral convs + 3x3/BN/LeakyReLU refine, bilinear align_corners=True
2x upsampling as two products with interpolation operators in the input's
dtype (the JAX package's default einsum path; its GIM_TPU_GATHER_UPSAMPLE
/ GIM_TPU_UPSAMPLE_V2 variants are TPU layouts of the same math).
Outputs: coarse 256ch @1/8, fine 128ch @1/2.

The trunk is the ResNet-50 that gim_dkm's encoder shares
(`models/resnet.py`). Layout: NCHW inside; parameter names follow the
reference state dict
(`backbone.encode.layer1.0.conv1.weight`, `backbone.layer2_outconv2.3`,
...). BatchNorm uses its running statistics unless `forward` is given
`train=True` (training: the batch's statistics, in the trunk and in the
FPN's two `layer{1,2}_outconv2` BatchNorms).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gim_tpu_torch.models.common import batchnorm, conv
from gim_tpu_torch.models.resnet import ResNet50, _bn, _conv
from gim_tpu_torch.utils.device import device_constant


def _interp_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) align_corners=True linear-interpolation operator in
    like's dtype, on its device (copied there once)."""
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), lo), 1.0 - (pos - lo))
    np.add.at(m, (np.arange(n_out), hi), pos - lo)
    return device_constant(f"interp{n_in}to{n_out}", m,
                           like.device).to(like.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x, align_corners=True, as two products with interpolation
    operators (the JAX package's default form; F.interpolate's math). Its
    backward is two products, where F.interpolate's accumulates with
    atomics on CUDA: a training step is reproducible (torch's
    deterministic mode refuses the bilinear backward)."""
    H, W = x.shape[-2:]
    x = x @ _interp_matrix(W, 2 * W, x).T
    return _interp_matrix(H, 2 * H, x) @ x


class ResNetFPN(nn.Module):
    """FPN over the ResNet-50 trunk (ref resnet.py:274-329)."""

    def __init__(self, block_dims=(64, 128, 196, 256, 512, 1024)):
        super().__init__()
        bd = block_dims
        # conv1 + layer1..3, no maxpool (ref resnet.py:158-169,230-235):
        # layer1 at 1/2 (256ch), layer2 at 1/4 (512ch), layer3 at 1/8
        self.encode = ResNet50(num_layers=3, maxpool=False)
        self.layer3_outconv = _conv(1024, bd[3], 1)
        self.layer2_outconv = _conv(512, bd[3], 1)
        self.layer2_outconv2 = nn.Sequential(
            _conv(bd[3], bd[3], 3), _bn(bd[3]), nn.LeakyReLU(0.01),
            _conv(bd[3], bd[2], 3))
        self.layer1_outconv = _conv(256, bd[2], 1)
        self.layer1_outconv2 = nn.Sequential(
            _conv(bd[2], bd[2], 3), _bn(bd[2]), nn.LeakyReLU(0.01),
            _conv(bd[2], bd[1], 3))

    def forward(self, x, train: bool = False):
        """x: (B, 3, H, W) -> coarse (B, 256, H/8, W/8), fine
        (B, 128, H/2, W/2). `train`: batch statistics in every
        BatchNorm."""
        dt = x.dtype

        def refine(seq, h):              # conv3x3, BN, LeakyReLU, conv3x3
            h = batchnorm(seq[1], conv(seq[0], h, dt), dt, train)
            return conv(seq[3], F.leaky_relu(h, 0.01), dt)

        # the stem's output is not kept: it would outlive the FPN
        x1, x2, x3 = self.encode(x, train)[1:]
        x3_out = conv(self.layer3_outconv, x3, dt)
        x2_out = conv(self.layer2_outconv, x2, dt)
        x2_out = refine(self.layer2_outconv2, x2_out + upsample2x(x3_out))
        x1_out = conv(self.layer1_outconv, x1, dt)
        x1_out = refine(self.layer1_outconv2, x1_out + upsample2x(x2_out))
        return x3_out, x1_out
