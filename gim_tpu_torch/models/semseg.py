"""Semantic segmentation (ADE20K, 150 classes) for masking sky, people and
cars in the video factory (port of `gim_tpu/models/semseg.py:28-170`).

The CSAIL mit_semseg stack the reference uses
(ref networks/mit_semseg/models/models.py:21-120, resnet.py:97-147): a
deep-stem ResNet-50 with layer3 and layer4 dilated (2 and 4) for a 1/8
output stride and 2048 channels, then the PPM decoder (models.py:389-436;
pool scales 1, 2, 3, 6, 512 channels each), with the JAX package's pooling
rule: average pools of (H // scale) x (W // scale) cells, cropped to
scale x scale (`gim_tpu/models/semseg.py:107-108`). Every BatchNorm is in
eval mode, eps 1e-5. `jax.image.resize(..., "bilinear")` is a half-pixel
resize whose edge taps renormalise; for the upsampling the model does
(and the 1 x 1 maps) that is `F.interpolate(mode="bilinear",
align_corners=False)`, which clamps at the edge to the same value.

Parameter names are the mit_semseg torch keys (encoder `conv1`, `bn1`,
..., `layer3.0.downsample.0`; decoder `ppm.{i}.1` / `.2`, `conv_last.0`,
`.1`, `.4`) under `encoder.` and `decoder.`, so the reference's
`encoder_epoch_20.pth` and `decoder_epoch_20.pth` load through
`weights/port.semseg_state_dict`, and `gim_tpu/weights/port.py`'s
`port_semseg` turns this module's state dict into the JAX variables.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# 0-based ADE20K ids of the classes masked by the reference pipeline
MASKED_CLASSES = {"sky": 2, "person": 12, "car": 20}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(cin, cout, k, stride=1, dilation=1, bias=False):
    pad = dilation * (k // 2)
    return nn.Conv2d(cin, cout, k, stride, pad, dilation, bias=bias)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5)


class DilatedBottleneck(nn.Module):
    """Bottleneck with the stride on the 3 x 3 and its dilation
    (`gim_tpu/models/semseg.py:28-58`)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
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


class ResNet50DilatedEncoder(nn.Module):
    """Deep-stem ResNet-50, layer3 dilation 2, layer4 dilation 4, stride 8,
    2048 channels (resnet50dilated, dilate_scale 8;
    `gim_tpu/models/semseg.py:61-94`)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv(64, 64, 3)
        self.bn2 = _bn(64)
        self.conv3 = _conv(64, 128, 3)
        self.bn3 = _bn(128)
        cin = 128
        for name, planes, blocks, stride, dil in (("layer1", 64, 3, 1, 1),
                                                  ("layer2", 128, 4, 2, 1),
                                                  ("layer3", 256, 6, 1, 2),
                                                  ("layer4", 512, 3, 1, 4)):
            layer = [DilatedBottleneck(cin, planes, stride, dil, True)]
            layer += [DilatedBottleneck(planes * 4, planes, 1, dil)
                      for _ in range(1, blocks)]
            setattr(self, name, nn.Sequential(*layer))
            cin = planes * 4

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = F.relu(self.bn3(self.conv3(h)))
        h = F.max_pool2d(h, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(h))))


class PPMDecoder(nn.Module):
    """Pyramid pooling decoder (PPM, ref models.py:389-436;
    `gim_tpu/models/semseg.py:97-124`)."""

    def __init__(self, num_classes: int = 150, fc_dim: int = 2048,
                 pool_scales: tuple[int, ...] = (1, 2, 3, 6)):
        super().__init__()
        self.pool_scales = pool_scales
        # index 0 is the reference's pooling module, which holds no weights
        self.ppm = nn.ModuleList(
            nn.Sequential(nn.Identity(), _conv(fc_dim, 512, 1), _bn(512))
            for _ in pool_scales)
        # 2 and 3 are the reference's ReLU and Dropout
        self.conv_last = nn.Sequential(
            _conv(fc_dim + len(pool_scales) * 512, 512, 3), _bn(512),
            nn.ReLU(), nn.Identity(), _conv(512, num_classes, 1, bias=True))

    def forward(self, conv5):
        H, W = conv5.shape[-2:]
        outs = [conv5]
        for scale, branch in zip(self.pool_scales, self.ppm):
            # maps smaller than the scale keep their own size
            ph, pw = max(H // scale, 1), max(W // scale, 1)
            pooled = F.avg_pool2d(conv5, (ph, pw), (ph, pw))
            pooled = pooled[..., :min(scale, H), :min(scale, W)]
            h = F.relu(branch[2](branch[1](pooled)))
            outs.append(F.interpolate(h, size=(H, W), mode="bilinear",
                                      align_corners=False))
        return self.conv_last(torch.cat(outs, 1))


class SegmentationModel(nn.Module):
    """rgb (B, 3, H, W) float in [0, 1] -> logits (B, num_classes, H, W),
    ImageNet-normalised in, resized to the input out
    (`gim_tpu/models/semseg.py:127-143`, which returns NHWC)."""

    def __init__(self, num_classes: int = 150):
        super().__init__()
        self.num_classes = num_classes
        self.encoder = ResNet50DilatedEncoder()
        self.decoder = PPMDecoder(num_classes)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        H, W = rgb.shape[-2:]
        mean = rgb.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
        std = rgb.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
        logits = self.decoder(self.encoder((rgb - mean) / std))
        return F.interpolate(logits, size=(H, W), mode="bilinear",
                             align_corners=False)


def build_segmenter(state_dict: dict | None = None,
                    generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda"
                    ) -> SegmentationModel:
    """A SegmentationModel in eval mode on `device` (CUDA unless the CPU is
    asked for; raises without it): seeded random weights from `generator`
    (default seed 0), then `state_dict` (this module's keys) if given."""
    from gim_tpu_torch.models.common import init_weights
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = SegmentationModel()
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(dev).eval()


def make_segmenter(model: SegmentationModel, img_size: int = 640,
                   classes: tuple[int, ...] = tuple(MASKED_CLASSES.values())):
    """`segment(rgb uint8 (h, w, 3)) -> bool mask (h, w)` of the masked
    classes (the interface of ref hloc/utils/__init__.py:41-49;
    `gim_tpu/models/semseg.py:152-170`). The frame is resized on the host
    with cv2 to `img_size` on its long side (multiples of 8), segmented by
    `model` on its device, and the class map resized back with cv2's
    nearest neighbour."""
    import cv2

    dev = next(model.parameters()).device
    wanted = torch.tensor(classes, device=dev)

    @torch.no_grad()
    def segment(rgb: np.ndarray) -> np.ndarray:
        h, w = rgb.shape[:2]
        s = img_size / max(h, w)
        nh = max(int(round(h * s)) // 8 * 8, 8)
        nw = max(int(round(w * s)) // 8 * 8, 8)
        small = cv2.resize(rgb, (nw, nh)).astype(np.float32) / 255.0
        x = torch.from_numpy(np.transpose(small, (2, 0, 1))[None]).to(dev)
        pred = model(x).argmax(1)[0]
        mask = torch.isin(pred, wanted).cpu().numpy()
        return cv2.resize(mask.astype(np.uint8), (w, h),
                          interpolation=cv2.INTER_NEAREST).astype(bool)

    return segment
