"""WALK training data, the dataset half: pseudo-label storage and the
training pairs built from propagated labels (host side, numpy and cv2).

Port of `gim_tpu/data/walk.py:49-79` (`LabelStore`) and `:217-294`
(`WalkSample`, `WalkDataset`), copied as they are. Reference semantics:
the train `__getitem__` of ref datasets/walk/walk.py:367-418 and
datasets/walk/utils.py:196-365: random rescale, crop and horizontal flip
with the keypoints re-warped, and a fixed-size label pad.

Label store layout: `<labels_root>/<seq>/<method>_s<skip>_r<resize>/`
holding `{i}_{j}.npy` (N, 4) float32 [x0 y0 x1 y1] at source resolution,
plus `index.npy` (P, 3) rows [i, j, n_matches]. A propagated pair file
holds a header row [i0 i1 i0 i1], then its (N, 4) labels.

The propagation half (`Propagator`, `link`, the fundamental-matrix
filter) is not ported here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from os.path import exists, join

import numpy as np

from gim_tpu_torch.data.augment import build_augmentor
from gim_tpu_torch.data.zeb import preprocess_host


class LabelStore:
    """Reads/writes per-pair pseudo-label .npy files for one source
    (method, skip, resize)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index: list[tuple[int, int, int]] = []
        ip = join(root, "index.npy")
        if exists(ip):
            self._index = [tuple(r) for r in np.load(ip).astype(np.int64)]

    def path(self, i: int, j: int) -> str:
        return join(self.root, f"{i}_{j}.npy")

    def save(self, i: int, j: int, labels: np.ndarray):
        np.save(self.path(i, j), labels.astype(np.float32))
        self._index.append((i, j, len(labels)))

    def load(self, i: int, j: int) -> np.ndarray | None:
        p = self.path(i, j)
        return np.load(p) if exists(p) else None

    def flush_index(self):
        np.save(join(self.root, "index.npy"),
                np.array(self._index, np.int64).reshape(-1, 3))

    def pairs(self) -> set[tuple[int, int]]:
        return {(i, j) for i, j, _ in self._index}


@dataclass
class WalkSample:
    color0: np.ndarray       # (3, S, S) float32
    color1: np.ndarray
    labels: np.ndarray       # (max_labels, 4) resized-frame px
    label_valid: np.ndarray  # (max_labels,)


class WalkDataset:
    """Training pairs from propagated labels with geometric augmentation.

    Random rescale + crop + horizontal flip applied consistently to a
    frame and its label endpoints; labels padded to a fixed budget (100k
    in the reference; configurable: the supervision is purely 2D)."""

    def __init__(self, frames, propagated_root: str, img_size: int = 840,
                 max_labels: int = 20000, augmentation: str | None = "dark",
                 seed: int = 0):
        self.frames = frames            # callable idx -> rgb uint8
        self.root = propagated_root
        self.img_size = img_size
        self.max_labels = max_labels
        self.rng = np.random.default_rng(seed)
        self.augment = build_augmentor(augmentation)
        self.items = sorted(
            f for f in os.listdir(propagated_root) if f.endswith(".npy"))

    def __len__(self):
        return len(self.items)

    def _geo_aug(self, rgb, kpts):
        """Random rescale [0.7, 1.0] + crop + hflip, rewarping kpts."""
        H, W = rgb.shape[:2]
        s = self.rng.uniform(0.7, 1.0)
        nh, nw = int(H * s), int(W * s)
        y0 = int(self.rng.integers(0, H - nh + 1))
        x0 = int(self.rng.integers(0, W - nw + 1))
        rgb = rgb[y0:y0 + nh, x0:x0 + nw]
        kpts = kpts - np.array([x0, y0], np.float32)
        ok = ((kpts[:, 0] >= 0) & (kpts[:, 0] < nw)
              & (kpts[:, 1] >= 0) & (kpts[:, 1] < nh))
        if self.rng.random() < 0.5:
            rgb = rgb[:, ::-1].copy()
            kpts = np.stack([nw - 1 - kpts[:, 0], kpts[:, 1]], axis=1)
        return rgb, kpts, ok

    def __getitem__(self, idx) -> WalkSample | None:
        arr = np.load(join(self.root, self.items[idx]))
        i0, i1 = arr[0, :2].astype(np.int64).tolist()
        labels = arr[1:]
        rgb0 = self.frames(i0)
        rgb1 = self.frames(i1)
        if self.augment is not None:
            rgb0 = self.augment(rgb0)
            rgb1 = self.augment(rgb1)
        rgb0, k0, ok0 = self._geo_aug(rgb0, labels[:, :2])
        rgb1, k1, ok1 = self._geo_aug(rgb1, labels[:, 2:])
        ok = ok0 & ok1
        k0, k1 = k0[ok], k1[ok]
        if len(k0) < 32:
            return None

        c0, _, s0, _, _ = preprocess_host(rgb0, self.img_size, 8, True)
        c1, _, s1, _, _ = preprocess_host(rgb1, self.img_size, 8, True)
        k0 = k0 / s0[None]
        k1 = k1 / s1[None]

        n = min(len(k0), self.max_labels)
        lab = np.zeros((self.max_labels, 4), np.float32)
        lab[:n, :2] = k0[:n]
        lab[:n, 2:] = k1[:n]
        valid = np.zeros(self.max_labels, bool)
        valid[:n] = True
        return WalkSample(c0, c1, lab, valid)
