"""Training losses and step of the dense matchers (gim_dkm, gim_roma).

Port of `gim_tpu/train/dense_losses.py`. GIM fine-tunes DKM and RoMa on
WALK video pseudo-labels (ref datasets/walk/walk.py:367-418,
README.md:239-245); the supervision is the JAX package's:

- the sparse labels are scattered into each scale's grid: a cell of image
  0 that holds at least one label gets the mean normalised target in
  image 1 as its flow (`scatter_sparse_warp`);
- flow: generalised Charbonnier over the labelled cells, per scale,
  weighted coarser to finer (`SCALE_WEIGHTS`; DKM eq. 8, RoMa sec. 3.4);
- certainty: balanced BCE, positive at labelled cells, negative elsewhere
  with the weight that equalises the two classes' masses;
- RoMa also supervises its scale-16 anchor classifier with cross-entropy
  against the anchor bin that holds the target (`_anchor_cls_loss`).

Both matchers train through their symmetric 2B pass: rows B..2B take the
labels with their ends swapped.

Data parallel: every normaliser (the labelled cells `m.sum()`, the class
masses `n_pos` and `n_neg`, the weights' sum) is the global batch's
(`parallel.mesh.global_sum`), so each process's loss is its share of the
global batch's loss, as in `train/losses.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gim_tpu_torch.models.roma import RoMaMatcher
from gim_tpu_torch.parallel.mesh import global_sum
from gim_tpu_torch.train import loop

# coarser scales get more weight (they set up the refinement cascade)
SCALE_WEIGHTS = {32: 1.0, 16: 1.0, 8: 0.5, 4: 0.25, 2: 0.125, 1: 0.125}
CERT_WEIGHT = 0.5


def scatter_sparse_warp(labels: torch.Tensor, label_valid: torch.Tensor,
                        in_hw: tuple[int, int], hs: int, ws: int):
    """labels (B, N, 4) [x0, y0, x1, y1] pixels of the (H, W) input frame
    -> each cell's flow at (hs, ws): the mean normalised target of the
    valid labels that start in it (cells clipped to the grid).

    Returns (gt_flow (B, hs, ws, 2) in [-1, 1], gt_mask (B, hs, ws)). The
    sums are `index_add_`s: labels sharing a cell add in any order."""
    H, W = in_hw
    B, N, _ = labels.shape
    ix = (labels[..., 0] * ws / W).to(torch.int32).clamp(0, ws - 1)
    iy = (labels[..., 1] * hs / H).to(torch.int32).clamp(0, hs - 1)
    cell = (iy * ws + ix).long()                               # (B, N)
    flat = (cell + hs * ws * torch.arange(B, device=labels.device)[:, None]
            ).reshape(-1)
    # normalised target coordinates (torch's grid convention, pixel centres)
    tx = 2.0 * (labels[..., 2] + 0.5) / W - 1.0
    ty = 2.0 * (labels[..., 3] + 0.5) / H - 1.0
    w = label_valid.to(labels.dtype)
    tgt = torch.stack([tx, ty], dim=-1) * w[..., None]          # (B, N, 2)
    acc = labels.new_zeros((B * hs * ws, 2)).index_add_(
        0, flat, tgt.reshape(-1, 2))
    cnt = labels.new_zeros(B * hs * ws).index_add_(0, flat, w.reshape(-1))
    gt_flow = (acc / cnt.clamp_min(1.0)[:, None]).reshape(B, hs, ws, 2)
    return gt_flow, (cnt > 0).reshape(B, hs, ws)


def _charbonnier(d: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.sqrt(torch.sum(d * d, dim=-1) + eps * eps) - eps


def _balanced_bce(logits: torch.Tensor, pos_mask: torch.Tensor
                  ) -> torch.Tensor:
    """BCE with the negative class weighted down to the positive mass
    (optax's sigmoid_binary_cross_entropy, in its log-sigmoid form)."""
    pos = pos_mask.to(logits.dtype)
    n_pos = global_sum(pos.sum()).clamp_min(1.0)
    n_neg = global_sum((1.0 - pos).sum()).clamp_min(1.0)
    w = pos + (1.0 - pos) * (n_pos / n_neg)
    ll = -pos * F.logsigmoid(logits) - (1.0 - pos) * F.logsigmoid(-logits)
    return torch.sum(ll * w) / global_sum(w.sum()).clamp_min(1.0)


def _flow_key(d: dict) -> tuple[str, str]:
    return (("dense_flow", "dense_certainty") if "dense_flow" in d
            else ("flow", "certainty"))


def dense_warp_loss(corresps: dict, labels: torch.Tensor,
                    label_valid: torch.Tensor, in_hw: tuple[int, int],
                    roma_cls: bool = False, cls_res: int = 64):
    """Per-scale flow and certainty loss over a symmetric 2B batch.

    corresps: {scale: {"flow"/"dense_flow" (2B, h, w, 2), "certainty"/
    "dense_certainty" (2B, h, w, 1)[, "gm_cls"]}}; labels (B, N, 4) image 0
    -> image 1, rows B..2B take them swapped. Returns (loss, {"flow_{s}"}):
    this process's shares of the global batch's."""
    lab2 = torch.cat([labels, torch.cat([labels[..., 2:4], labels[..., 0:2]],
                                        -1)], dim=0)             # (2B, N, 4)
    lv2 = torch.cat([label_valid, label_valid], dim=0)
    total = 0.0
    logs = {}
    for s, d in corresps.items():
        fkey, ckey = _flow_key(d)
        flow, cert = d[fkey], d[ckey]
        hs, ws = flow.shape[1:3]
        gt_flow, gt_mask = scatter_sparse_warp(lab2, lv2, in_hw, hs, ws)
        m = gt_mask.to(flow.dtype)
        l_flow = (torch.sum(_charbonnier(flow - gt_flow.to(flow.dtype)) * m)
                  / global_sum(m.sum()).clamp_min(1.0))
        l_cert = _balanced_bce(cert[..., 0], gt_mask)
        wsc = SCALE_WEIGHTS.get(int(s), 0.25)
        total = total + wsc * (l_flow + CERT_WEIGHT * l_cert)
        logs[f"flow_{s}"] = l_flow
        if roma_cls and "gm_cls" in d:
            total = total + wsc * _anchor_cls_loss(d["gm_cls"], gt_flow,
                                                   gt_mask, cls_res)
    return total, logs


def _anchor_cls_loss(cls_logits: torch.Tensor, gt_flow: torch.Tensor,
                     gt_mask: torch.Tensor, res: int) -> torch.Tensor:
    """Cross-entropy against the anchor bin that holds the target (RoMa's
    match decoder as a classifier, ref roma.py:276-297); the anchors are
    laid out as `models/roma/model.cls_to_flow_refine` reads them."""
    g = ((gt_flow + 1.0) / 2.0 * res).to(torch.int32).clamp(0, res - 1)
    target = (g[..., 1] * res + g[..., 0]).long()              # (B, H, W)
    logp = torch.log_softmax(cls_logits[..., :res * res], dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    m = gt_mask.to(nll.dtype)
    return torch.sum(nll * m) / global_sum(m.sum()).clamp_min(1.0)


def dkm_loss(model, batch: dict):
    """gim_dkm's training pass (`DKMMatcher.train_corresps`, a model built
    with train_mode) and `dense_warp_loss`."""
    corresps = model.train_corresps(batch["color0"], batch["color1"])
    return dense_warp_loss(corresps, batch["labels"], batch["label_valid"],
                           tuple(batch["color0"].shape[2:]))


def roma_loss(model: RoMaMatcher, batch: dict):
    """gim_roma's training pass (`RoMaMatcher.train_corresps`) and
    `dense_warp_loss` with the anchor classifier's loss."""
    corresps = model.train_corresps(batch["color0"], batch["color1"])
    return dense_warp_loss(corresps, batch["labels"], batch["label_valid"],
                           tuple(batch["color0"].shape[2:]), roma_cls=True,
                           cls_res=model.cfg.cls_to_coord_res)


def dense_loss(model, batch: dict):
    """`roma_loss` for a RoMaMatcher, else `dkm_loss`."""
    if not model.train_mode:
        raise ValueError("dense losses need a model built with train_mode")
    if isinstance(model, RoMaMatcher):
        return roma_loss(model, batch)
    return dkm_loss(model, batch)


def dense_train_step(model, optimizer, scheduler, batch: dict) -> dict:
    """`train.loop.train_step` on `dense_loss`: one update of a gim_dkm or
    gim_roma matcher built with train_mode (the optimizer holds every
    parameter, the frozen DINOv2's too, as the JAX step updates them).
    batch: color0/color1 (B, 3, H, W), labels (B, N, 4) pixels of that
    frame, label_valid (B, N). Returns {"loss", "flow_{s}"}."""
    return loop.train_step(lambda: dense_loss(model, batch), optimizer,
                           scheduler)
