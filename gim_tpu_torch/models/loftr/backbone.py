"""ResNet-50 bottleneck FPN backbone for gim_loftr (1/8 + 1/2 features).

Port of `gim_tpu/models/loftr/backbone.py` (reference: GIM's RGB ResNet-50
variant, ref networks/loftr/backbone/resnet.py:247-329 — Bottleneck
[3,4,6,3], 7x7/2 stem, NO maxpool, truncated after layer3). FPN heads:
1x1 lateral convs + 3x3/BN/LeakyReLU refine, bilinear align_corners=True
2x upsampling (the math of the JAX package's default einsum path; its
GIM_TPU_GATHER_UPSAMPLE / GIM_TPU_UPSAMPLE_V2 variants are TPU layouts of
the same math). Outputs: coarse 256ch @1/8, fine 128ch @1/2.

Layout: NCHW inside; parameter names follow the reference state dict
(`backbone.encode.layer1.0.conv1.weight`, `backbone.layer2_outconv2.3`,
...). BatchNorm uses its running statistics (eval).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    # symmetric padding k//2: torch pads a stride-2 3x3 by 1 on both sides
    # (the JAX package passes ((1,1),(1,1)) explicitly for this)
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (stride on the 3x3)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = (nn.Sequential(_conv(cin, planes * 4, 1, stride),
                                         _bn(planes * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


def _layer(cin: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    layers = [Bottleneck(cin, planes, stride, downsample=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50Trunk(nn.Module):
    """conv1(7x7/2) + layer1..3, no maxpool (ref resnet.py:158-169,230-235)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.layer1 = _layer(64, 64, 3, 1)      # 1/2, 256ch
        self.layer2 = _layer(256, 128, 4, 2)    # 1/4, 512ch
        self.layer3 = _layer(512, 256, 6, 2)    # 1/8, 1024ch

    def forward(self, x):
        x0 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        return x1, x2, x3


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class ResNetFPN(nn.Module):
    """FPN over the ResNet-50 trunk (ref resnet.py:274-329)."""

    def __init__(self, block_dims=(64, 128, 196, 256, 512, 1024)):
        super().__init__()
        bd = block_dims
        self.encode = ResNet50Trunk()
        self.layer3_outconv = _conv(1024, bd[3], 1)
        self.layer2_outconv = _conv(512, bd[3], 1)
        self.layer2_outconv2 = nn.Sequential(
            _conv(bd[3], bd[3], 3), _bn(bd[3]), nn.LeakyReLU(0.01),
            _conv(bd[3], bd[2], 3))
        self.layer1_outconv = _conv(256, bd[2], 1)
        self.layer1_outconv2 = nn.Sequential(
            _conv(bd[2], bd[2], 3), _bn(bd[2]), nn.LeakyReLU(0.01),
            _conv(bd[2], bd[1], 3))

    def forward(self, x):
        """x: (B, 3, H, W) -> coarse (B, 256, H/8, W/8), fine
        (B, 128, H/2, W/2)."""
        x1, x2, x3 = self.encode(x)
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv(x2)
        x2_out = self.layer2_outconv2(x2_out + upsample2x_align_corners(x3_out))
        x1_out = self.layer1_outconv(x1)
        x1_out = self.layer1_outconv2(x1_out + upsample2x_align_corners(x2_out))
        return x3_out, x1_out
