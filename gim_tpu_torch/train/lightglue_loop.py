"""gim_lightglue training: SuperPoint and LightGlue trained jointly on
pseudo-labels.

Port of `gim_tpu/train/lightglue_loop.py`. LightGlue's NLL
(`train/losses.lightglue_nll_loss`, ref networks/lightglue/models/
matchers/lightglue.py:580-629) on the WALK 2D correspondences (ref
README.md:245). As in the JAX package, the detector is trained from the
same labels (its module docstring says why a frozen random detector
cannot be learnt from):

1. detector CE: 65-way cell classification, each 8 x 8 cell that holds a
   label's end pixel targets that pixel's class, every other cell the
   dustbin (class 64);
2. descriptor InfoNCE at the labels' two ends (negatives within 8 px
   masked);
3. LightGlue's NLL on the GT assignment of the *detected* keypoints
   (`assign_gt_matches`).

The empty keypoint slots are placed from fixed draws on every step, as
the JAX step passes PRNGKey(1) and PRNGKey(2) (`:168-169`): here
generators seeded 1 and 2 (`pad_draws`), or the uniforms a caller passes
as `pad_noise0` / `pad_noise1` (the tests pass JAX's).

Data parallel: every normaliser is the global batch's
(`parallel.mesh.global_sum`) and the pad draws are the global batch's, of
which each process takes its rows, so each process's loss is its share
of the global batch's loss.
"""

from __future__ import annotations

import torch

from gim_tpu_torch.models.superpoint import LUMA
from gim_tpu_torch.ops.detect import remove_borders, simple_nms, topk_keypoints
from gim_tpu_torch.ops.sampling import sample_descriptors
from gim_tpu_torch.parallel import mesh
from gim_tpu_torch.parallel.mesh import global_sum
from gim_tpu_torch.train import loop
from gim_tpu_torch.train.losses import lightglue_nll_loss
from gim_tpu_torch.utils.device import device_constant

PAD_SEEDS = (1, 2)


def assign_gt_matches(kpts0, valid0, kpts1, valid1, labels, label_valid,
                      gt_thr: float = 3.0) -> torch.Tensor:
    """(B, K) partner index into kpts1, or -1, for every kpts0 slot: the
    nearest valid label start within gt_thr px of a valid keypoint, then
    the valid keypoint of image 1 nearest that label's end, within gt_thr
    (the first index on ties, as argmin takes it).

    kpts: (B, K, 2); labels: (B, N, 4) [x0 y0 x1 y1] in the same frame."""
    big = 1e12
    d0 = torch.sum((kpts0[:, :, None, :] - labels[:, None, :, :2]) ** 2, -1)
    d0 = torch.where(label_valid[:, None, :], d0, big)
    v0, li = d0.min(dim=2)                                   # (B, K)
    ok0 = (v0 < gt_thr ** 2) & valid0
    target = torch.gather(labels[..., 2:], 1,
                          li[..., None].expand(-1, -1, 2))   # (B, K, 2)
    d1 = torch.sum((target[:, :, None, :] - kpts1[:, None, :, :]) ** 2, -1)
    d1 = torch.where(valid1[:, None, :], d1, big)
    v1, j = d1.min(dim=2)
    return torch.where(ok0 & (v1 < gt_thr ** 2), j, -1)


def _dense_forward(net, image: torch.Tensor):
    """One SuperPoint forward on (B, 1 | 3, H, W) (RGB to luma in the
    image's dtype): (scores (B, H, W), descriptors (B, D, Hc, Wc), cell
    logits (B, Hc, Wc, 65))."""
    if image.shape[1] == 3:
        w = device_constant("superpoint.luma", LUMA, image.device)
        image = (image * w.to(image.dtype).reshape(1, 3, 1, 1)).sum(
            1, keepdim=True)
    return net(image, return_logits=True)


def _sparse_from_dense(scores, desc, cfg, pad_noise):
    """`models.superpoint.extract`'s sparse stage on a dense forward
    already computed: NMS, borders, top-k (empty slots placed at
    `pad_noise` (B, K, 2) when the config forces the count), descriptor
    sampling."""
    s = simple_nms(scores, cfg.nms_radius)
    s = remove_borders(s, cfg.remove_borders)
    kpts, kscores, valid = topk_keypoints(
        s, cfg.max_num_keypoints, cfg.detection_threshold,
        pad_noise=pad_noise if cfg.force_num_keypoints else None)
    d = sample_descriptors(kpts, desc, 8, legacy=cfg.legacy_sampling)
    return {"keypoints": kpts + 0.5, "scores": kscores, "valid": valid,
            "descriptors": d}


def superpoint_detection_loss(logits, pts_xy, pts_valid) -> torch.Tensor:
    """65-way cell CE (SuperPoint's MagicPoint objective, ref
    superpoint.py:229-235): cells holding a label's end pixel target that
    pixel's class, all others the dustbin; positive and dustbin cells
    weigh equally.

    logits: (B, Hc, Wc, 65); pts_xy: (B, N, 2) full-resolution px;
    pts_valid (B, N). Where several valid ends fall in one cell, the last
    of them (largest index) sets its target, deterministically; the JAX
    package's scatter (`.at[].set`) fixes no order there."""
    B, hc, wc, _ = logits.shape
    n = pts_xy.shape[1]
    xi = pts_xy[..., 0].to(torch.int32).clamp(0, wc * 8 - 1)
    yi = pts_xy[..., 1].to(torch.int32).clamp(0, hc * 8 - 1)
    ncell = hc * wc
    cell = torch.where(pts_valid, (yi // 8) * wc + (xi // 8), ncell).long()
    cls = ((yi % 8) * 8 + (xi % 8)).long()
    # the last valid end of each cell; invalid ends parked in slot ncell
    last = torch.full((B, ncell + 1), -1, dtype=torch.long,
                      device=logits.device).scatter_reduce_(
        1, cell, torch.arange(n, device=logits.device).expand(B, n), "amax")
    last = last[:, :ncell]
    tgt = torch.where(last >= 0, torch.gather(cls, 1, last.clamp_min(0)), 64)
    ll = torch.log_softmax(logits.reshape(B, ncell, 65), dim=-1)
    ce = -torch.gather(ll, -1, tgt[..., None])[..., 0]
    pos = (tgt != 64).to(ce.dtype)
    n_pos = global_sum(pos.sum()).clamp_min(1.0)
    n_neg = global_sum((1.0 - pos).sum()).clamp_min(1.0)
    return (torch.sum(ce * pos) / n_pos
            + torch.sum(ce * (1.0 - pos)) / n_neg) * 0.5


def superpoint_descriptor_loss(desc0, desc1, labels, label_valid,
                               n_max: int = 1024, temp: float = 0.1,
                               safe_px: float = 8.0) -> torch.Tensor:
    """Symmetric InfoNCE between the descriptors sampled at the two ends of
    the first `n_max` labels; negatives within `safe_px` of the positive
    are masked.

    desc: (B, D, Hc, Wc) dense maps; labels (B, N, 4); label_valid (B, N)."""
    lab = labels[:, :n_max]
    lv = label_valid[:, :n_max]
    f0 = sample_descriptors(lab[..., :2], desc0, 8)           # (B, n, D)
    f1 = sample_descriptors(lab[..., 2:], desc1, 8)
    sim = torch.einsum("bnd,bmd->bnm", f0, f1) / temp
    close1 = torch.sum((lab[:, :, None, 2:] - lab[:, None, :, 2:]) ** 2,
                       -1) < safe_px ** 2
    close0 = torch.sum((lab[:, :, None, :2] - lab[:, None, :, :2]) ** 2,
                       -1) < safe_px ** 2
    eye = torch.eye(lab.shape[1], dtype=torch.bool, device=lab.device)[None]
    neg_inf = -1e9
    valid_pair = lv[:, :, None] & lv[:, None, :]
    m01 = torch.where((close1 & ~eye) | ~valid_pair, neg_inf, sim)
    m10 = torch.where((close0 & ~eye) | ~valid_pair, neg_inf, sim)
    diag01 = torch.diagonal(torch.log_softmax(m01, dim=2), dim1=1, dim2=2)
    diag10 = torch.diagonal(torch.log_softmax(m10, dim=1), dim1=1, dim2=2)
    w = lv.to(sim.dtype)
    n = global_sum(w.sum()).clamp_min(1.0)
    return -(torch.sum(diag01 * w) + torch.sum(diag10 * w)) / (2.0 * n)


def pad_draws(B: int, K: int, device) -> list[torch.Tensor]:
    """The pad uniforms (B, K, 2) of both images, from generators on
    `device` seeded PAD_SEEDS on every call. Under a process group, the
    global batch's draws, of which this process takes its B rows."""
    n, r = mesh.world_size(), mesh.rank()
    return [torch.rand((n * B, K, 2), device=device,
                       generator=torch.Generator(device).manual_seed(s)
                       )[r * B:(r + 1) * B] for s in PAD_SEEDS]


def lightglue_loss(model, cfg, batch: dict, pad_noise0=None, pad_noise1=None,
                   w_det: float = 1.0, w_desc: float = 1.0):
    """The joint loss: SuperPoint's detector CE and descriptor InfoNCE,
    both from the labels, plus LightGlue's NLL on the detected keypoints'
    GT assignment.

    model: {"superpoint", "lightglue"} (`api.build_model("gim_lightglue")`);
    cfg: the GimConfig; batch: color0/color1 (B, 3, H, W), labels (B, N, 4)
    pixels, label_valid (B, N). Returns (loss, {"nll", "det", "desc",
    "gt_matches"}), this process's shares of the global batch's."""
    B, _, H, W = batch["color0"].shape
    sp_cfg = cfg.superpoint
    if pad_noise0 is None or pad_noise1 is None:
        pad_noise0, pad_noise1 = pad_draws(B, sp_cfg.max_num_keypoints,
                                           batch["color0"].device)
    labels, lv = batch["labels"], batch["label_valid"]
    s0, dm0, lg0 = _dense_forward(model["superpoint"], batch["color0"])
    s1, dm1, lg1 = _dense_forward(model["superpoint"], batch["color1"])
    p0 = _sparse_from_dense(s0, dm0, sp_cfg, pad_noise0)
    p1 = _sparse_from_dense(s1, dm1, sp_cfg, pad_noise1)
    wh = torch.tensor([[W, H]], dtype=p0["keypoints"].dtype,
                      device=labels.device).expand(B, 2)
    out = model["lightglue"](p0["keypoints"], p1["keypoints"],
                             p0["descriptors"], p1["descriptors"], wh, wh,
                             p0["valid"], p1["valid"])
    gt0 = assign_gt_matches(p0["keypoints"], p0["valid"], p1["keypoints"],
                            p1["valid"], labels, lv)
    nll = lightglue_nll_loss(out["log_assignment"], gt0, p0["valid"],
                             p1["valid"])
    det = (superpoint_detection_loss(lg0, labels[..., :2], lv)
           + superpoint_detection_loss(lg1, labels[..., 2:], lv)) * 0.5
    desc = superpoint_descriptor_loss(dm0, dm1, labels, lv)
    loss = nll + w_det * det + w_desc * desc
    n_gt = torch.sum(gt0 >= 0).to(loss.dtype) / (B * mesh.world_size())
    return loss, {"nll": nll, "det": det, "desc": desc, "gt_matches": n_gt}


def lightglue_train_step(model, optimizer, scheduler, cfg, batch: dict,
                         pad_noise0=None, pad_noise1=None) -> dict:
    """`train.loop.train_step` on `lightglue_loss`: one update of SuperPoint
    *and* LightGlue (the optimizer holds both). Returns {"loss", "nll",
    "det", "desc", "gt_matches"}."""
    return loop.train_step(
        lambda: lightglue_loss(model, cfg, batch, pad_noise0, pad_noise1),
        optimizer, scheduler)
