"""WALK training data: pseudo-label storage, propagation, and the
training pairs built from propagated labels (host side, numpy and cv2;
the fundamental-matrix filter on the card).

Port of `gim_tpu/data/walk.py`: `create_table` and `link` (:31-47),
`LabelStore` (:49-79), `PropagationConfig` and `Propagator` (:81-190),
`onchip_fundamental_filter` (:193-214), `WalkSample` and `WalkDataset`
(:217-294). Reference semantics (ref datasets/walk/walk.py): the
pixel-hash `create_table` (:29) and the chain intersection `link`
(:217-247); the recursive multi-skip `propagate` (:170-215), filtered by
fundamental RANSAC and recorded in a ledger of bad pairs (:289-306); the
train `__getitem__` (:367-418, datasets/walk/utils.py:196-365): random
rescale, crop and horizontal flip with the keypoints re-warped, and a
fixed-size label pad.

Label store layout: `<labels_root>/<seq>/<method>_s<skip>_r<resize>/`
holding `{i}_{j}.npy` (N, 4) float32 [x0 y0 x1 y1] at source resolution,
plus `index.npy` (P, 3) rows [i, j, n_matches]. A propagated pair file
holds a header row [i0 i1 i0 i1], then its (N, 4) labels.

`link` runs the port's compiled chain linker (`gim_tpu_torch/native/`),
which raises if it cannot be built.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from os.path import exists, join

import numpy as np

from gim_tpu_torch.data.augment import build_augmentor
from gim_tpu_torch.data.zeb import preprocess_host


def create_table(x: np.ndarray, y: np.ndarray, w: int) -> dict:
    """Pixel hash -> row index (ref walk.py:29)."""
    keys = np.round(x) + np.round(y) * w
    return dict(zip(keys.tolist(), range(len(x))))


def link(label0: np.ndarray, label1: np.ndarray, width: int,
         min_final_matches: int = 64) -> np.ndarray | None:
    """Chain two consecutive label sets through their shared middle frame
    by exact-pixel intersection (ref walk.py:217-247)."""
    from gim_tpu_torch.native import link_fast

    out = link_fast(label0, label1, width)
    if len(out) < min_final_matches:
        return None
    return out


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
class PropagationConfig:
    skips: tuple[int, ...] = (10, 20, 40)
    min_final_matches: int = 64
    pix_thr: float = 1.0          # MAGSAC threshold on chained labels (:295)
    min_keep: int = 64


class Propagator:
    """Chains per-skip label sources into long-gap supervision
    (ref walk.py:170-306)."""

    def __init__(self, sources: dict[int, list[LabelStore]],
                 frame_width: int, cfg: PropagationConfig,
                 out_root: str):
        self.sources = sources
        self.width = frame_width
        self.cfg = cfg
        self.out_root = out_root
        os.makedirs(out_root, exist_ok=True)

    def dump(self, skip: int, pair: tuple[int, int]) -> np.ndarray:
        """Concat labels from all sources at this skip (ref walk.py:249-266)."""
        labels = [s.load(*pair) for s in self.sources.get(skip, [])]
        labels = [l for l in labels if l is not None and len(l)]
        if labels:
            return np.concatenate(labels, axis=0).astype(np.float32)
        return np.zeros((0, 4), np.float32)

    def propagate(self, idx0: int, idx1: int,
                  skips: tuple[int, ...]) -> tuple:
        """Recursive multi-skip chaining (ref walk.py:170-215)."""
        skip = skips[-1]
        indices = [skip * (i + 1) + idx0 for i in range((idx1 - idx0) // skip)]
        if not indices or idx0 != indices[0]:
            indices = [idx0] + indices
        if idx1 != indices[-1]:
            indices = indices + [idx1]
        segs = list(zip(indices[:-1], indices[1:]))

        labels: list[np.ndarray] = []
        ids = [idx0]
        while segs:
            pair = segs.pop(0)
            if pair[0] == pair[1]:
                break
            label = []
            if (pair[1] - pair[0]) == skip:
                tmp = self.dump(skip, pair)
                if len(tmp) > 0:
                    label.append(tmp)
            if skips[:-1]:
                sub, i0, i1 = self.propagate(pair[0], pair[1], skips[:-1])
                if (i0, i1) == pair and sub is not None:
                    label.append(sub)
            if label:
                labels.append(np.concatenate(label, axis=0))
                ids.append(pair[1])
            if len(labels) > 1:
                chained = link(labels[0], labels[1], self.width,
                               self.cfg.min_final_matches)
                if chained is not None:
                    labels = [chained]
                    ids = [ids[0], ids[-1]]
                else:
                    labels.pop(-1)
                    ids.pop(-1)
                    segs = [(pair[0], pair[1] - skips[0])]

        if len(labels) == 1 and len(ids) == 2:
            return labels[0], ids[0], ids[-1]
        return None, None, None

    def propagate_pair(self, idx0: int, idx1: int, ransac_filter=None):
        """Full per-pair path with skip fallbacks, the robust filter
        `ransac_filter(k0, k1, pix_thr) -> keep mask` and the ledger
        (ref walk.py:272-306). Returns (labels, i0, i1) or None."""
        out = join(self.out_root, f"{idx0}_{idx1}.npy")
        if exists(out):
            arr = np.load(out)
            i0, i1 = arr[0, :2].astype(np.int64).tolist()
            return arr[1:], i0, i1

        skips = self.cfg.skips
        labels, i0, i1 = self.propagate(idx0, idx1, skips)
        if i1 is not None and i1 - i0 == skips[-1]:
            labels, i0, i1 = self.propagate(i0, i1, skips[:-1])
        if i1 is not None and i1 - i0 == skips[-2]:
            labels, i0, i1 = self.propagate(i0, i1, skips[:-2])

        def bad():
            with open(join(self.out_root, "bad_pairs.txt"), "a") as f:
                f.write(f"{idx0} {idx1}\n")
            return None

        if labels is None:
            return bad()

        if ransac_filter is not None:
            keep = ransac_filter(labels[:, :2], labels[:, 2:],
                                 self.cfg.pix_thr)
            labels = labels[keep]
        if len(labels) < self.cfg.min_keep or (i1 - i0) == skips[-3]:
            return bad()

        header = np.array([[i0, i1, i0, i1]], np.float32)
        np.save(out, np.concatenate([header, labels], axis=0))
        return labels, i0, i1


def onchip_fundamental_filter(k0: np.ndarray, k1: np.ndarray,
                              thresh: float, *, device="cuda",
                              noise=None) -> np.ndarray:
    """RANSAC inlier filter on pseudo labels: fundamental RANSAC with 1024
    hypotheses on the card in place of the reference's per-pair cv2
    USAC_MAGSAC (ref walk.py:295-297). The points are padded to a power of
    two (at least 8), as in the JAX package; JAX's `PRNGKey(n)` becomes one
    generator seeded n on `device`, unless `noise` gives RANSAC's two
    uniform banks ((1, 1024, M), (1, 256, M)). Returns the (n,) keep
    mask."""
    import torch

    from gim_tpu_torch.geometry.ransac import ransac
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n = len(k0)
    if n < 8:
        return np.zeros(n, bool)
    M = 1 << int(np.ceil(np.log2(max(n, 8))))
    p0 = np.pad(k0, ((0, M - n), (0, 0))).astype(np.float32)
    p1 = np.pad(k1, ((0, M - n), (0, 0))).astype(np.float32)
    valid = np.zeros(M, bool)
    valid[:n] = True
    gens = None if noise is not None else [
        torch.Generator(dev).manual_seed(int(n))]
    res = ransac(torch.from_numpy(p0[None]).to(dev),
                 torch.from_numpy(p1[None]).to(dev),
                 torch.from_numpy(valid[None]).to(dev), thresh,
                 model_kind="fundamental", num_hypotheses=1024, noise=noise,
                 generators=gens)
    return res.inliers[0, :n].cpu().numpy()


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
