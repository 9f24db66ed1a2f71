"""Dense-match keypoint quantization and aggregation (port of
`gim_tpu/hloc/quantize.py`, copied: host numpy and scipy).

The clever bit of the reference's dense SfM path (ref hloc/match_dense.py:
49-390): dense matchers have no repeatable detections, so match endpoints
are quantized into `cell_size` bins, votes are accumulated per bin across
all pairs, each cell emits one canonical keypoint (its best `max_error`
sub-bin), and matches are then re-assigned to canonical keypoints by
nearest-neighbour search within `max_error` px.

Host-side numpy/scipy (this feeds COLMAP, which is host C++ anyway).
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np


def quantize_pts(kpts: np.ndarray, ps: float) -> np.ndarray:
    """Snap keypoints to a ps-pitch grid of cell centers
    (ref match_dense.py:44-47)."""
    if ps > 0.0:
        return np.round(np.round((kpts + 0.5) / ps) * ps - 0.5, 2)
    return kpts


class KeypointAggregator:
    """Per-image accumulation of quantized match endpoints."""

    def __init__(self, cell_size: int = 8, max_error: float = 2.0):
        self.cell_size = max(cell_size, max_error)
        self.max_error = max_error
        self.cells: dict[str, dict[tuple, int]] = defaultdict(dict)
        self.bins: dict[str, list[Counter]] = defaultdict(list)

    def add(self, name: str, kpts: np.ndarray,
            scores: np.ndarray | None = None) -> np.ndarray:
        """Assign match endpoints to (possibly new) cells; returns cell ids."""
        cpts = quantize_pts(kpts, self.cell_size)
        bpts = quantize_pts(kpts, int(self.max_error))
        cells = self.cells[name]
        bins = self.bins[name]
        ids = np.empty(len(kpts), np.int64)
        for i, (cpt, bpt) in enumerate(zip(map(tuple, cpts),
                                           map(tuple, bpts))):
            kid = cells.get(cpt)
            if kid is None:
                kid = len(cells)
                cells[cpt] = kid
                bins.append(Counter())
            bins[kid][bpt] += float(scores[i]) if scores is not None else 1.0
            ids[i] = kid
        return ids

    def finalize(self, name: str, max_kps: int | None = None):
        """Canonical keypoints: the highest-vote sub-bin per cell
        (ref match_dense.py:363-377). Returns (kpts (N,2), scores (N,))."""
        bins = self.bins[name]
        if not bins:
            return np.zeros((0, 2), np.float32), np.zeros(0, np.float32)
        kpts = np.array([c.most_common(1)[0][0] for c in bins], np.float32)
        score = np.array([c.most_common(1)[0][1] for c in bins], np.float32)
        if max_kps and len(kpts) > max_kps:
            top = np.argsort(score)[::-1][:max_kps]
            kpts, score = kpts[top], score[top]
        return kpts, score


def assign_to_keypoints(kpts: np.ndarray, canonical: np.ndarray,
                        max_error: float) -> np.ndarray:
    """NN assignment of match endpoints to canonical keypoints
    (ref match_dense.py:58-63). Returns index per point or -1."""
    if len(canonical) == 0 or len(kpts) == 0:
        return np.full(len(kpts), -1, np.int64)
    from scipy.spatial import cKDTree

    dist, ids = cKDTree(canonical).query(kpts)
    ids = ids.astype(np.int64)
    ids[dist > max_error] = -1
    return ids


def unique_matches(match_ids: np.ndarray, scores: np.ndarray):
    """Keep the best-scoring match per keypoint on each side, mutual
    (ref match_dense.py:100-112)."""
    if len(match_ids) == 0:
        return match_ids, scores
    keep = set()
    for col in (0, 1):
        best: dict[int, int] = {}
        for i, (mid, sc) in enumerate(zip(match_ids[:, col], scores)):
            if mid not in best or sc > scores[best[mid]]:
                best[mid] = i
        keep = keep & set(best.values()) if keep else set(best.values())
    keep = sorted(keep)
    return match_ids[keep], scores[keep]


def matches_from_ids(ids0: np.ndarray, ids1: np.ndarray,
                     scores: np.ndarray):
    """Match endpoint cell-ids -> unique (id0, id1) matches."""
    ok = (ids0 >= 0) & (ids1 >= 0)
    m = np.stack([ids0[ok], ids1[ok]], axis=1)
    return unique_matches(m, scores[ok])
