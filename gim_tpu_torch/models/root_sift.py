"""RootSIFT baseline matcher (port of `gim_tpu/models/root_sift.py`).

The reference's trainer/lightning.py:195-241: cv2 SIFT detection on the
host, RootSIFT normalization (L1-normalize then sqrt), mutual-NN + ratio
test 0.8 from the descriptor similarity. The similarity matmul and the
mutual/ratio selection run on the device; detection stays on the host
(the reference also keeps SIFT on the CPU through OpenCV), and cv2 is
imported inside the function that detects.
"""

from __future__ import annotations

import numpy as np
import torch

from gim_tpu_torch.utils.device import resolve_device


def detect_rootsift(rgb_u8: np.ndarray, max_kpts: int | None = None):
    """cv2 SIFT + RootSIFT descriptors. rgb: (H, W, 3) uint8.
    Returns kpts (N, 2) float32, desc (N, 128) float32 (RootSIFT)."""
    import cv2

    H, W = rgb_u8.shape[:2]
    n = max_kpts or (H * W // 64)
    sift = cv2.SIFT_create(nfeatures=n, contrastThreshold=1e-5)
    bgr = cv2.cvtColor(rgb_u8, cv2.COLOR_RGB2BGR)
    kpts, desc = sift.detectAndCompute(bgr, None)
    if desc is None or len(kpts) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32)
    pts = np.array([kp.pt for kp in kpts], np.float32)
    desc = desc.astype(np.float32)
    desc = np.sqrt(desc / np.maximum(desc.sum(axis=1, keepdims=True), 1e-12))
    return pts, desc


def pad_to(arr: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    m = arr.shape[0]
    valid = np.zeros(n, bool)
    valid[:min(m, n)] = True
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:min(m, n)] = arr[:n]
    return out, valid


def match_rootsift(kpts0, desc0, valid0, kpts1, desc1, valid1,
                   ratio: float = 0.8):
    """Device-side mutual-NN + ratio matching (ref lightning.py:217-227).

    Fixed-shape tensors on one device; returns (matches to kpts1 index or
    -1, mconf) aligned with kpts0's slots. Ties go to the first index, as
    jnp.argmax's do."""
    sim = desc0 @ desc1.T                                # (N0, N1) cosine
    sim = torch.where(valid0[:, None] & valid1[None, :], sim, -1e9)
    rmax = sim.amax(1, keepdim=True)
    mutual = (sim == rmax) & (sim == sim.amax(0, keepdim=True))
    has = mutual.any(1)
    idx = mutual.to(torch.uint8).argmax(1)
    # Lowe ratio on descriptor L2 distance: d = sqrt(2 - 2 sim)
    top2 = sim.topk(2, dim=1).values
    d = (-2.0 * top2 + 2.0).clamp_min(0.0).sqrt()
    ratio_ok = (d[:, 0] / d[:, 1].clamp_min(1e-12)) < ratio
    ok = has & ratio_ok & valid0
    return torch.where(ok, idx, -1), torch.where(ok, rmax[:, 0], 0.0)


def match_pair_rootsift(rgb0: np.ndarray, rgb1: np.ndarray,
                        max_kpts: int = 4096, ratio: float = 0.8,
                        device: str | torch.device = "cuda"):
    """The host + device RootSIFT pipeline on one RGB pair (original
    resolution). Returns (mkpts0 (M, 2), mkpts1 (M, 2), mconf (M,))
    numpy arrays."""
    dev = resolve_device(device)
    k0, d0 = detect_rootsift(rgb0)
    k1, d1 = detect_rootsift(rgb1)
    k0p, v0 = pad_to(k0, max_kpts)
    d0p, _ = pad_to(d0, max_kpts)
    k1p, v1 = pad_to(k1, max_kpts)
    d1p, _ = pad_to(d1, max_kpts)
    m, conf = match_rootsift(*(torch.from_numpy(a).to(dev) for a in (
        k0p, d0p, v0, k1p, d1p, v1)), ratio)
    m = m.cpu().numpy()
    conf = conf.cpu().numpy()
    sel = m >= 0
    return k0p[sel], k1p[m[sel]], conf[sel]
