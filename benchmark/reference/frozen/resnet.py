"""The torchvision ResNet-50 layout that gim_loftr and gim_dkm share.

Port of the bottleneck stacks of `gim_tpu/models/loftr/backbone.py`
(GIM's RGB ResNet-50: 7x7/2 stem, no maxpool, layer1..3) and
`gim_tpu/models/dkm/encoder.py:17-86` (torchvision's ResNet-50: stem,
3x3/2 maxpool, layer1..4, no `fc`). Parameter names are torchvision's
(`conv1`, `bn1`, `layer{i}.{b}.conv{c}`, `layer{i}.{b}.downsample.{0,1}`).

Every layer computes in the dtype of its input: parameters stored in
another dtype are cast at each layer (`models/common.py`), as the JAX
package does. BatchNorm uses its running statistics (eval; the DKM
encoder's freeze_bn) unless `forward` is given `train=True`, which
threads the switch to every BatchNorm (gim_loftr's training:
`models/common.batchnorm_train`). The stride-2 1x1 `downsample` conv has
no padding, which is what flax's SAME gives a 1x1 kernel: on an odd size
both sample rows 0, 2, ..., so 165 -> 83.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.frozen.common import batchnorm, conv


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

    def forward(self, x, train: bool = False):
        dt = x.dtype
        out = F.relu(batchnorm(self.bn1, conv(self.conv1, x, dt), dt, train))
        out = F.relu(batchnorm(self.bn2, conv(self.conv2, out, dt), dt,
                               train))
        out = batchnorm(self.bn3, conv(self.conv3, out, dt), dt, train)
        if self.downsample is None:
            idn = x
        else:
            idn = batchnorm(self.downsample[1],
                            conv(self.downsample[0], x, dt), dt, train)
        return F.relu(out + idn)


def _layer(cin: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    layers = [Bottleneck(cin, planes, stride, downsample=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


# (planes, blocks, stride) of layer1..4
_LAYERS = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class ResNet50(nn.Module):
    """conv1 (7x7/2) + bn1 + ReLU, an optional 3x3/2 maxpool (padding 1,
    -inf outside, as JAX's max_pool), then layer1..layer{num_layers}."""

    def __init__(self, num_layers: int, maxpool: bool):
        super().__init__()
        self.maxpool = maxpool
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for i, (planes, blocks, stride) in enumerate(_LAYERS[:num_layers]):
            setattr(self, f"layer{i + 1}", _layer(cin, planes, blocks, stride))
            cin = planes * 4
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> list[torch.Tensor]:
        """x: (B, 3, H, W) in the compute dtype. Returns the stem's output
        (stride 2) and each layer's, in x's dtype. `train`: every
        BatchNorm normalises with the batch's statistics and updates its
        running ones."""
        dt = x.dtype
        h = F.relu(batchnorm(self.bn1, conv(self.conv1, x, dt), dt, train))
        outs = [h]
        if self.maxpool:
            h = F.max_pool2d(h, 3, 2, 1)
        for i in range(1, self.num_layers + 1):
            for block in getattr(self, f"layer{i}"):
                h = block(h, train)
            outs.append(h)
        return outs
