"""Image preprocessing ops: resize, grayscale, pad, normalize (port of
`gim_tpu/ops/image.py`).

The contract of the reference's preprocessing (datasets/utils.py:80-126
`read_images`, tools/__init__.py:202-218 `get_padding_size`): the resize
geometry (new H/W, scales, pad offsets) is host integer arithmetic,
identical to the reference's, and the pixel work (bilinear resample, pad,
grayscale, normalize) runs on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from gim_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Host-side geometry arithmetic (ints only; mirrors reference semantics)
# ---------------------------------------------------------------------------


def resized_wh(w: int, h: int, resize: int | None) -> tuple[int, int]:
    """Resize so the longer edge equals `resize` (ref datasets/utils.py:34-40)."""
    if resize is None:
        return w, h
    scale = resize / max(h, w)
    return int(round(w * scale)), int(round(h * scale))


def divisible_wh(w: int, h: int, df: int | None) -> tuple[int, int]:
    """Floor both edges to a multiple of df, min df (ref datasets/utils.py:43-53)."""
    if df is None:
        return w, h
    return max(w // df, 1) * df, max(h // df, 1) * df


def target_wh(w: int, h: int, max_resize: int,
              df: int | None = 8) -> tuple[int, int]:
    """Full reference resize rule: shrink-only longest-edge resize then /df
    floor (ref datasets/utils.py:102-108)."""
    if max(w, h) > max_resize:
        w, h = resized_wh(w, h, max_resize)
    return divisible_wh(w, h, df)


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Aspect-ratio padding to a (h, w) canvas, centered.

    Mirrors `get_padding_size` (ref tools/__init__.py:202-218): pads the
    image symmetrically so its aspect ratio matches w/h (used by DKM/RoMa
    before resizing to the fixed model resolution).
    """

    orig_w: int
    orig_h: int
    left: int
    right: int
    top: int
    bottom: int

    @property
    def padded_wh(self) -> tuple[int, int]:
        return (self.orig_w + self.left + self.right,
                self.orig_h + self.top + self.bottom)


def aspect_pad_spec(orig_h: int, orig_w: int, h: int, w: int) -> PadSpec:
    aspect = w / h
    new_w = max(orig_w, int(orig_h * aspect))
    new_h = max(orig_h, int(orig_w / aspect))
    ph, pw = new_h - orig_h, new_w - orig_w
    top, left = ph // 2, pw // 2
    return PadSpec(orig_w, orig_h, left, pw - left, top, ph - top)


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------

# ITU-R BT.601 luma weights: cv2.cvtColor(..., COLOR_RGB2GRAY).
_LUMA = (0.299, 0.587, 0.114)


def _channels_last(image: torch.Tensor) -> bool:
    return image.dim() >= 3 and image.shape[-1] <= 4


def rgb_to_gray(image: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """RGB -> grayscale with cv2/BT.601 weights; drops the channel axis."""
    img = image.movedim(channel_axis, -1).float()
    return (img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1]
            + img[..., 2] * _LUMA[2])


def resize_bilinear(image: torch.Tensor, new_h: int,
                    new_w: int) -> torch.Tensor:
    """Bilinear resize, float32, half-pixel centres and no antialiasing:
    cv2.resize(INTER_LINEAR) semantics, as `jax.image.resize(...,
    "bilinear", antialias=False)`. `image` is (..., H, W, C) with C <= 4
    or (..., H, W)."""
    x = image.float()
    last = _channels_last(x)
    if last:
        x = x.movedim(-1, -3)                         # (..., C, H, W)
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(new_h, new_w),
                      mode="bilinear", align_corners=False, antialias=False)
    y = y.reshape(*lead, new_h, new_w)
    return y.movedim(-3, -1) if last else y


def pad_bottom_right(image: torch.Tensor, pad_size: int,
                     ret_mask: bool = False):
    """Zero-pad (..., H, W[, C]) to a square (pad_size, pad_size) canvas,
    content anchored top-left (ref datasets/utils.py:56-72)."""
    if _channels_last(image):
        h, w = image.shape[-3], image.shape[-2]
        padded = F.pad(image, (0, 0, 0, pad_size - w, 0, pad_size - h))
    else:
        h, w = image.shape[-2], image.shape[-1]
        padded = F.pad(image, (0, pad_size - w, 0, pad_size - h))
    if not ret_mask:
        return padded, None
    mask = torch.zeros((pad_size, pad_size), dtype=torch.bool,
                       device=image.device)
    mask[:h, :w] = True
    return padded, mask


def aspect_pad(image: torch.Tensor, spec: PadSpec) -> torch.Tensor:
    """Centered zero-pad of (..., C, H, W) per PadSpec (ref demo.py:425-428)."""
    return F.pad(image, (spec.left, spec.right, spec.top, spec.bottom))


def aspect_unpad_mask(kpts: torch.Tensor, spec: PadSpec):
    """Shift keypoints (..., 2) in xy back to the unpadded frame, plus a
    validity mask (ref demo.py:447-462)."""
    x = kpts[..., 0] - spec.left
    y = kpts[..., 1] - spec.top
    ok = (x >= 0) & (x < spec.orig_w) & (y >= 0) & (y < spec.orig_h)
    return torch.stack([x, y], dim=-1), ok


def normalize_imagenet(image: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalization of (..., 3, H, W) images in [0, 1]."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=image.dtype)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=image.dtype)
    return ((image - mean.to(image.device).view(3, 1, 1))
            / std.to(image.device).view(3, 1, 1))


@dataclasses.dataclass(frozen=True)
class Preprocessed:
    """Output of `preprocess_image`: device tensors + geometry."""

    gray: torch.Tensor           # (1, H, W) float in [0,1], padded if asked
    color: torch.Tensor          # (3, H, W) float in [0,1]
    scale: torch.Tensor          # (2,) [w/w_new, h/h_new]
    mask: torch.Tensor | None    # (H, W) bool if padded
    resize_hw: tuple[int, int]


def preprocess_image(rgb_u8: np.ndarray, max_resize: int,
                     df: int | None = 8, padding: bool = False,
                     device: str | torch.device = "cuda") -> Preprocessed:
    """Reference `read_images` pipeline with the pixel work on `device`
    (the reference's datasets/utils.py:80-126)."""
    dev = resolve_device(device)
    h, w = rgb_u8.shape[:2]
    w_new, h_new = target_wh(w, h, max_resize, df)
    img = torch.from_numpy(np.ascontiguousarray(rgb_u8)).to(dev)
    color = resize_bilinear(img, h_new, w_new)            # (h', w', 3) f32
    gray = rgb_to_gray(color)                             # (h', w')
    scale = torch.tensor([w / w_new, h / h_new], dtype=torch.float32,
                         device=dev)
    mask = None
    if padding:
        color, _ = pad_bottom_right(color, max_resize)
        gray, mask = pad_bottom_right(gray, max_resize, ret_mask=True)
    return Preprocessed(gray=gray[None] / 255.0,
                        color=color.movedim(-1, 0) / 255.0, scale=scale,
                        mask=mask, resize_hw=(h_new, w_new))
