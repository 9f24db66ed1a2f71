"""Training losses for the matcher heads.

Port of `gim_tpu/train/losses.py`. gim_loftr: focal loss on the
dual-softmax coarse confidence matrix plus the L2-with-std fine loss (ref
networks/loftr/config.py:49-68: FOCAL_ALPHA 0.25, FOCAL_GAMMA 2.0,
FINE_TYPE 'l2_with_std', FINE_CORRECT_THR 1.0), supervised by 2D
pseudo-label correspondences (ref datasets/walk/walk.py:367-418). Label
points map to coarse cells in both images by a scatter into an (L, S)
matrix: static shapes, on the device.

Data parallel. A loss's normalisers that are sums over the batch (counts
of positive and negative cells, of valid fine slots, the mean inverse std)
go through `parallel.mesh.global_sum`: under a process group they are
those of the global batch and each process returns its share of the
global loss; the shares add up to the loss of the global batch, which is
what the JAX package's step takes.
"""

from __future__ import annotations

import torch

from gim_tpu_torch.parallel.mesh import global_sum


def label_cells(x: torch.Tensor, y: torch.Tensor, hw_c: tuple[int, int],
                scale: int) -> torch.Tensor:
    """Pixel coordinates -> flattened coarse cell ids, clipped to the grid."""
    hc, wc = hw_c
    cx = torch.div(x, scale, rounding_mode="floor").clamp(0, wc - 1)
    cy = torch.div(y, scale, rounding_mode="floor").clamp(0, hc - 1)
    return (cy * wc + cx).long()


def coarse_gt_from_labels(labels: torch.Tensor, label_valid: torch.Tensor,
                          hw_c: tuple[int, int], scale: int = 8
                          ) -> torch.Tensor:
    """Pseudo-label correspondences -> coarse GT assignment matrix.

    labels: (B, N, 4) [x0, y0, x1, y1] pixel coords in the resized frame;
    label_valid: (B, N). Returns conf_gt (B, L, L) in {0, 1}: a scatter-max
    of the labels' validity, so padded labels (weight 0) leave cell 0 at 0.
    """
    hc, wc = hw_c
    L = hc * wc
    i = label_cells(labels[..., 0], labels[..., 1], hw_c, scale)
    j = label_cells(labels[..., 2], labels[..., 3], hw_c, scale)
    B = labels.shape[0]
    upd = torch.zeros((B, L * L), dtype=torch.float32, device=labels.device)
    upd.scatter_reduce_(1, i * L + j, label_valid.float(), "amax",
                        include_self=True)
    return upd.reshape(B, L, L)


def fine_gt_from_labels(labels: torch.Tensor, label_valid: torch.Tensor,
                        i_ids: torch.Tensor, mkpts1_c: torch.Tensor,
                        hw_c: tuple[int, int], scale: int, denom: float):
    """Pseudo-label correspondences -> fine-stage GT offsets.

    The fine head refines the correspondence of the coarse grid point
    mkpts0_c = (cx, cy) * scale, so the target is warp(grid point),
    estimated from the labels of its cell by a local translation:
    warp(g) ~= centroid1 + (g - centroid0) (`gim_tpu/train/losses.py:47`
    says why not the centroid itself).

    labels: (B, N, 4) resized-frame px; i_ids: (B, M) matched image-0
    cells; mkpts1_c: (B, M, 2). Returns (expec_gt (B, M, 2) normalised by
    denom, has_gt (B, M)).
    """
    hc, wc = hw_c
    B = labels.shape[0]
    Lc = hc * wc
    cell0 = label_cells(labels[..., 0], labels[..., 1], hw_c, scale)
    w = label_valid.float()
    sum01 = torch.zeros((B, Lc, 4), device=labels.device)
    sum01.scatter_add_(1, cell0[..., None].expand(-1, -1, 4),
                       labels * w[..., None])
    cnt = torch.zeros((B, Lc), device=labels.device)
    cnt.scatter_add_(1, cell0, w)
    norm = cnt.clamp_min(1.0)[..., None]
    pos0 = sum01[..., 0:2] / norm
    pos1 = sum01[..., 2:4] / norm

    ids = i_ids.long()
    x = (ids % wc).float()
    y = torch.div(ids, wc, rounding_mode="floor").float()
    grid0 = torch.stack([x, y], dim=-1) * float(scale)
    idx = ids[..., None].expand(-1, -1, 2)
    gt1 = torch.gather(pos1, 1, idx) + grid0 - torch.gather(pos0, 1, idx)
    has_gt = torch.gather(cnt > 0, 1, ids)
    return (gt1 - mkpts1_c) / denom, has_gt


def coarse_focal_loss(conf: torch.Tensor, conf_gt: torch.Tensor,
                      alpha: float = 0.25, gamma: float = 2.0,
                      pos_weight: float = 1.0, neg_weight: float = 1.0,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Dual-softmax focal loss (LoFTR-style) on conf in [0, 1].

    conf/conf_gt: (B, L, S); valid: (B, L, S) cells that are in-image.

    The clamp before the log is 1e-30, not the reference's 1e-6: from
    scratch at L ~ 1e4 the dual-softmax starts uniform at 1/L^2 ~ 1e-8,
    every positive cell sits below a 1e-6 clamp, whose gradient is 0, and
    the coarse head never trains. 1e-30 only guards the log against 0;
    the value equals the reference's where conf > 1e-6.
    """
    pos = conf_gt > 0.5
    loss_pos = -alpha * (1 - conf) ** gamma \
        * torch.log(conf.clamp_min(1e-30))
    loss_neg = -(1 - alpha) * conf ** gamma \
        * torch.log((1 - conf).clamp_min(1e-30))
    if valid is None:
        valid = torch.ones_like(pos)
    pos_m = pos & valid
    neg_m = ~pos & valid
    n_pos = global_sum(pos_m.sum().float()).clamp_min(1.0)
    n_neg = global_sum(neg_m.sum().float()).clamp_min(1.0)
    lp = torch.sum(loss_pos * pos_m) / n_pos
    ln = torch.sum(loss_neg * neg_m) / n_neg
    return pos_weight * lp + neg_weight * ln


def fine_l2_std_loss(expec_f: torch.Tensor, expec_f_gt: torch.Tensor,
                     valid: torch.Tensor, correct_thr: float = 1.0
                     ) -> torch.Tensor:
    """L2 fine loss weighted by the inverse predicted std ('l2_with_std').

    expec_f: (B, M, 3) [x, y, std] in normalised window coordinates;
    expec_f_gt: (B, M, 2) GT offsets in the same frame; valid: (B, M)
    slots that exist and have GT. A slot counts where |gt| < correct_thr
    (ref FINE_CORRECT_THR). The inverse-std weight is normalised by its
    mean over all (B, M) slots, valid or not, and carries no gradient.
    """
    inverse_std = 1.0 / expec_f[..., 2].detach().clamp_min(1e-10)
    mean = (global_sum(inverse_std.sum())
            / global_sum(torch.tensor(float(inverse_std.numel()),
                                      device=expec_f.device)))
    weight = inverse_std / mean.clamp_min(1e-10)
    in_win = expec_f_gt.abs().amax(-1) < correct_thr
    m = valid & in_win
    offset_l2 = torch.sum((expec_f[..., :2] - expec_f_gt) ** 2, dim=-1)
    n = global_sum(m.sum().float()).clamp_min(1.0)
    return torch.sum(offset_l2 * weight * m) / n


def lightglue_nll_loss(log_assignment: torch.Tensor,
                       gt_matches0: torch.Tensor, valid0: torch.Tensor,
                       valid1: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of the GT assignment, balanced between
    matched and dustbin rows: (mean over matched + mean over unmatched) / 2
    (glue-factory's NLLLoss, which LightGlue's training uses).

    log_assignment: (B, L+1, S+1); gt_matches0: (B, L) partner index or
    -1; valid0: (B, L). valid1 is taken for the JAX signature's sake."""
    S = log_assignment.shape[2] - 1
    L = log_assignment.shape[1] - 1
    matched = (gt_matches0 >= 0) & valid0
    idx = torch.where(matched, gt_matches0, S).long()
    rows = torch.gather(log_assignment[:, :L, :], 2, idx[..., None])[..., 0]
    w_pos = matched.to(rows.dtype)
    w_neg = (valid0 & ~matched).to(rows.dtype)
    nll_pos = -torch.sum(rows * w_pos) / global_sum(w_pos.sum()).clamp_min(1)
    nll_neg = -torch.sum(rows * w_neg) / global_sum(w_neg.sum()).clamp_min(1)
    return 0.5 * (nll_pos + nll_neg)
