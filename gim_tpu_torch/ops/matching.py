"""Match-assignment ops: dual-softmax coarse matching, the fine sub-pixel
expectation and LightGlue's assignment.

Port of `gim_tpu/ops/matching.py:25-217` (reference semantics: LoFTR
CoarseMatching, ref networks/loftr/utils/coarse_matching.py:60-195,
FineMatching, ref utils/fine_matching.py:9-74, and LightGlue's
sigmoid-log-double-softmax and mutual filter, ref matchers/lightglue.py:
250-304). Outputs are static-shape:
dynamic selections become a capped top-k plus validity masks.

Ranking uses a stable descending sort, so among equal confidences the
lower index comes first, as `jax.lax.top_k` orders them (`torch.topk`
does not promise an order). Every argmax takes the first maximum, as
`jnp.argmax` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gim_tpu_torch.ops.kernels.dsmax import dual_softmax_mutual

INF = 1e9


def dual_softmax(sim: torch.Tensor, temperature: float,
                 mask0: torch.Tensor | None = None,
                 mask1: torch.Tensor | None = None) -> torch.Tensor:
    """conf = softmax(sim/T, rows) * softmax(sim/T, cols), padded cells
    -INF (coarse_matching.py:114-118). sim: [N, L, S]."""
    sim = sim / temperature
    if mask0 is not None:
        valid = mask0[..., None] & mask1[:, None]
        sim = sim.masked_fill(~valid, -INF)
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def _border_mask(hc: int, wc: int, border: int,
                 true_hw: torch.Tensor | None = None,
                 device=None) -> torch.Tensor:
    """(N?, hc*wc) bool: True for cells at least `border` cells from the
    edges. true_hw: (N, 2) actual content extent in cells when padded
    (mask_border_with_padding, coarse_matching.py:29-44)."""
    if true_hw is not None:
        device = true_hw.device
    ys = torch.arange(hc, device=device)[:, None].expand(hc, wc)
    xs = torch.arange(wc, device=device)[None, :].expand(hc, wc)
    if true_hw is None:
        ok = ((ys >= border) & (ys < hc - border)
              & (xs >= border) & (xs < wc - border))
        return ok.reshape(hc * wc)
    h = true_hw[:, 0, None, None]
    w = true_hw[:, 1, None, None]
    ok = ((ys[None] >= border) & (ys[None] < h - border)
          & (xs[None] >= border) & (xs[None] < w - border))
    return ok.reshape(-1, hc * wc)


def _batched_border(N: int, hw_c, border: int, true_hw, device):
    b = _border_mask(*hw_c, border, true_hw, device)
    return b if b.dim() == 2 else b[None].expand(N, -1)


def _topk_rows(mconf: torch.Tensor, max_matches: int):
    """Top max_matches of each row, lower index first among equal values,
    zero-padded when a row is shorter than the cap."""
    L = mconf.shape[1]
    k = min(max_matches, L)
    top_conf, i_ids = torch.sort(mconf, dim=1, descending=True, stable=True)
    top_conf, i_ids = top_conf[:, :k], i_ids[:, :k]
    if k < max_matches:
        pad = max_matches - k
        top_conf = torch.nn.functional.pad(top_conf, (0, pad))
        i_ids = torch.nn.functional.pad(i_ids, (0, pad))
    return top_conf, i_ids


def mutual_topk_matches(conf: torch.Tensor, *, hw0_c: tuple[int, int],
                        hw1_c: tuple[int, int], threshold: float,
                        border: int, max_matches: int,
                        true_hw0: torch.Tensor | None = None,
                        true_hw1: torch.Tensor | None = None):
    """Static-shape port of CoarseMatching.get_coarse_match (:150-195).

    conf: [N, L, S]. Returns dict of i_ids/j_ids (N, M) int32, mconf (N, M),
    valid (N, M) bool, where M = max_matches; matches are the mutually-
    nearest cells above threshold outside the border, ranked by confidence.
    """
    N, L, S = conf.shape
    mask = conf > threshold
    b0 = _batched_border(N, hw0_c, border, true_hw0, conf.device)
    b1 = _batched_border(N, hw1_c, border, true_hw1, conf.device)
    mask = mask & b0[:, :, None] & b1[:, None, :]
    mask = (mask
            & (conf == conf.amax(dim=2, keepdim=True))
            & (conf == conf.amax(dim=1, keepdim=True)))

    # at most one True per row -> its argmax is the j for each i (argmax of
    # a bool tensor is not implemented on CUDA: cast first)
    row_valid = mask.any(dim=2)
    j_ids = mask.to(torch.uint8).argmax(dim=2)
    mconf = torch.gather(conf, 2, j_ids[..., None])[..., 0]
    mconf = torch.where(row_valid, mconf, 0.0)

    top_conf, i_ids = _topk_rows(mconf, max_matches)
    j_sel = torch.gather(j_ids, 1, i_ids)
    return {"i_ids": i_ids.int(), "j_ids": j_sel.int(),
            "mconf": top_conf, "valid": top_conf > 0.0}


def fused_mutual_topk(n0: torch.Tensor, n1: torch.Tensor, temperature: float,
                      mask0, mask1, *, hw0_c, hw1_c, threshold, border,
                      max_matches, true_hw0=None, true_hw1=None):
    """`mutual_topk_matches` built on the fused dual-softmax kernel K1,
    with the whole batch in one launch per sweep: no (L, S) confidence
    matrix is materialised. Same outputs and semantics."""
    N = n0.shape[0]
    jbest, conf, mutual = dual_softmax_mutual(n0, n1, temperature,
                                              mask0, mask1)
    b0 = _batched_border(N, hw0_c, border, true_hw0, n0.device)
    b1 = _batched_border(N, hw1_c, border, true_hw1, n0.device)
    ok = mutual & (conf > threshold) & b0 & torch.gather(b1, 1, jbest)
    mconf = torch.where(ok, conf, 0.0)

    top_conf, i_ids = _topk_rows(mconf, max_matches)
    j_sel = torch.gather(jbest, 1, i_ids)
    return {"i_ids": i_ids.int(), "j_ids": j_sel.int(),
            "mconf": top_conf, "valid": top_conf > 0.0}


def cells_to_kpts(ids: torch.Tensor, wc: int, scale) -> torch.Tensor:
    """Flattened coarse cell ids -> xy pixel coords at original resolution
    (coarse_matching.py:240-248). scale broadcasts (scalar or (N,1,2))."""
    ids = ids.long()
    x = (ids % wc).float()
    y = torch.div(ids, wc, rounding_mode="floor").float()
    return torch.stack([x, y], dim=-1) * scale


def fine_expectation(feat_f0: torch.Tensor, feat_f1: torch.Tensor):
    """Fine sub-pixel refinement (fine_matching.py:15-60).

    feat_f0/feat_f1: [M, WW, C] window features. Returns
    (coords_normalized [M, 2] in [-1, 1] of the W x W window, std [M]).
    """
    M, WW, C = feat_f0.shape
    W = int(WW ** 0.5)
    picked = feat_f0[:, WW // 2, :]
    sim = torch.einsum("mc,mrc->mr", picked, feat_f1)
    heatmap = torch.softmax(sim / (C ** 0.5), dim=1)

    # normalized grid in [-1, 1] (kornia create_meshgrid semantics)
    lin = torch.linspace(-1.0, 1.0, W, device=feat_f0.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (WW, 2)

    coords = heatmap @ grid                                       # (M, 2)
    var = (heatmap @ (grid ** 2)) - coords ** 2
    std = torch.sqrt(var.clamp_min(1e-10)).sum(-1)
    return coords, std


def sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor,
                               z1: torch.Tensor) -> torch.Tensor:
    """(N, L+1, S+1) log-assignment with dustbins
    (`gim_tpu/ops/matching.py:180-194`). sim: (N, L, S); z0: (N, L), z1:
    (N, S) matchability logits."""
    N, L, S = sim.shape
    certainties = F.logsigmoid(z0)[..., None] + F.logsigmoid(z1)[:, None, :]
    scores0 = torch.log_softmax(sim, dim=2)
    scores1 = torch.log_softmax(sim, dim=1)
    scores = sim.new_zeros((N, L + 1, S + 1))
    scores[:, :L, :S] = scores0 + scores1 + certainties
    scores[:, :-1, -1] = F.logsigmoid(-z0)
    scores[:, -1, :-1] = F.logsigmoid(-z1)
    return scores


def filter_matches(scores: torch.Tensor, threshold: float):
    """Mutual nearest neighbours above `threshold` on the (N, L+1, S+1)
    log-assignment (`gim_tpu/ops/matching.py:197-217`). Returns m0 (N, L),
    m1 (N, S) (partner index, -1 if none), mscores0, mscores1."""
    inner = scores[:, :-1, :-1]
    max0, m0 = inner.max(dim=2)
    m1 = inner.argmax(dim=1)
    ind0 = torch.arange(m0.shape[1], device=scores.device)[None]
    ind1 = torch.arange(m1.shape[1], device=scores.device)[None]
    mutual0 = ind0 == torch.gather(m1, 1, m0)
    mutual1 = ind1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, max0.exp(), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    return (torch.where(valid0, m0, -1), torch.where(valid1, m1, -1),
            mscores0, mscores1)
