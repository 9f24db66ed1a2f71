"""SuperPoint detector and descriptor (port of `gim_tpu/models/superpoint.py`).

Reference: networks/lightglue/superpoint.py (VGG-style encoder :176-202,
65-way cell softmax score head :229-235, descriptor head :236-241, NMS
:61-81, sparse extraction :243-349). The reference's dynamic keypoint
selection is a capped top-k with validity masks, as in the JAX package.
Layout is NCHW; parameter names are the reference's (`conv1a` ...
`convDb`), which `gim_tpu/weights/port.py:port_superpoint` reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gim_tpu_torch.config import SuperPointConfig
from gim_tpu_torch.ops.detect import remove_borders, simple_nms, topk_keypoints
from gim_tpu_torch.ops.sampling import safe_l2_normalize, sample_descriptors
from gim_tpu_torch.utils.device import device_constant
from gim_tpu_torch.utils.profiling import span

LUMA = np.array([0.299, 0.587, 0.114], np.float32)  # ref superpoint.py:209


class SuperPointNet(nn.Module):
    """Dense heads (`gim_tpu/models/superpoint.py:27-73`); the sparse
    extraction is `extract`."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        for name, cin, cout in (("conv1a", 1, c1), ("conv1b", c1, c1),
                                ("conv2a", c1, c2), ("conv2b", c2, c2),
                                ("conv3a", c2, c3), ("conv3b", c3, c3),
                                ("conv4a", c3, c4), ("conv4b", c4, c4),
                                ("convPa", c4, c5), ("convDa", c4, c5)):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.convDb = nn.Conv2d(c5, descriptor_dim, 1)

    def forward(self, image: torch.Tensor, return_logits: bool = False):
        """image: (B, 1, H, W) gray. Returns scores (B, 8 Hc, 8 Wc) and
        L2-normalized descriptors (B, D, Hc, Wc), Hc = H // 8; with
        `return_logits` also the raw cell logits (B, Hc, Wc, 65), dustbin
        last, in the JAX package's layout (`superpoint.py:33`, `:66`), which
        the training loss reads (`train/lightglue_loop.py`)."""
        x = image
        for stage in ("1", "2", "3", "4"):
            x = F.relu(getattr(self, f"conv{stage}a")(x))
            x = F.relu(getattr(self, f"conv{stage}b")(x))
            if stage != "4":
                x = F.max_pool2d(x, 2, 2)
        # 65-way cell softmax, dustbin dropped, channel 8 * dy + dx of a
        # cell to pixel (8 y + dy, 8 x + dx): a pixel shuffle
        logits = self.convPb(F.relu(self.convPa(x)))
        scores = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :-1], 8)
        desc = safe_l2_normalize(self.convDb(F.relu(self.convDa(x))), dim=1)
        if return_logits:
            return scores[:, 0], desc, logits.permute(0, 2, 3, 1)
        return scores[:, 0], desc


@span("gim.superpoint")
def extract(net: SuperPointNet, image: torch.Tensor, cfg: SuperPointConfig,
            image_hw: torch.Tensor | None = None,
            pad_noise: torch.Tensor | None = None) -> dict:
    """Dense heads, NMS, borders, top-k and descriptor sampling
    (`gim_tpu/models/superpoint.py:80-112`).

    image: (B, 1 | 3, H, W) float in [0, 1] (RGB is turned to luma in the
    image's dtype); image_hw: (B, 2) true (h, w) of content on a padded
    canvas; pad_noise: (B, K, 2) uniforms that place the empty slots when
    `cfg.force_num_keypoints` (else they sit at (0, 0)). Returns
    keypoints (B, K, 2) xy with the +0.5 pixel-centre offset, scores and
    valid (B, K), descriptors (B, K, D)."""
    if image.shape[1] == 3:
        w = device_constant("superpoint.luma", LUMA, image.device)
        image = (image * w.to(image.dtype).reshape(1, 3, 1, 1)).sum(
            1, keepdim=True)
    scores, desc = net(image)
    with span("gim.superpoint.keypoints"):
        scores = simple_nms(scores, cfg.nms_radius)
        scores = remove_borders(scores, cfg.remove_borders, image_hw)
        kpts, kscores, valid = topk_keypoints(
            scores, cfg.max_num_keypoints, cfg.detection_threshold,
            pad_noise=pad_noise if cfg.force_num_keypoints else None,
            bounds_hw=image_hw)
    d = sample_descriptors(kpts, desc, 8, legacy=cfg.legacy_sampling)
    return {"keypoints": kpts + 0.5, "scores": kscores, "valid": valid,
            "descriptors": d}
