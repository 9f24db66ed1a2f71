"""Photometric training augmentations (host side, numpy and cv2).

Port of `gim_tpu/data/augment.py`, copied as it is: the equivalents of the
reference's albumentations pipelines (ref datasets/augment.py:4-49),
'dark' (night simulation: brightness drop, gamma, sensor noise; WALK's
training default, ref datasets/walk/__init__.py:32) and 'mobile'
(compression and blur artifacts).
"""

from __future__ import annotations

import numpy as np


def dark_aug(rgb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Night-style augmentation: strong brightness/contrast drop, gamma,
    sensor noise."""
    img = rgb.astype(np.float32) / 255.0
    brightness = rng.uniform(0.1, 0.5)
    contrast = rng.uniform(0.5, 1.0)
    gamma = rng.uniform(1.5, 3.0)
    img = np.clip((img - 0.5) * contrast + 0.5 + (brightness - 0.5), 0, 1)
    img = img ** gamma
    noise_sigma = rng.uniform(0.01, 0.04)
    img = img + rng.normal(0, noise_sigma, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def mobile_aug(rgb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Mobile-capture augmentation: jpeg-ish blur + mild color jitter."""
    import cv2

    img = rgb
    if rng.random() < 0.7:
        k = int(rng.integers(1, 3)) * 2 + 1
        img = cv2.GaussianBlur(img, (k, k), 0)
    if rng.random() < 0.7:
        q = int(rng.integers(40, 90))
        ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, q])
        if ok:
            img = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
    scale = rng.uniform(0.8, 1.2, 3).astype(np.float32)
    img = np.clip(img.astype(np.float32) * scale[None, None], 0, 255)
    return img.astype(np.uint8)


def build_augmentor(kind: str | None):
    """ref datasets/augment.py:52-60 registry. The augmentor draws from an
    unseeded generator, as the JAX package's does."""
    if kind is None or kind == "None":
        return None
    rng = np.random.default_rng()
    if kind == "dark":
        return lambda img: dark_aug(img, rng)
    if kind == "mobile":
        return lambda img: mobile_aug(img, rng)
    raise ValueError(f"unknown augmentation {kind}")
