"""The training step every head shares: forward in train mode, losses,
backward, clip, AdamW; and gim_loftr's step on it.

Port of `gim_tpu/train/loop.py`. `train_step` is the skeleton (zero the
gradients, the head's loss, `backward`, the clipped AdamW step, the
schedule); `loftr_train_step` here, `train/dense_losses.dense_train_step`
(gim_dkm, gim_roma) and `train/lightglue_loop.lightglue_train_step` give
it their losses. The optimizer follows ref
trainer/config.py:24-41 and test.py:158-165, as the JAX package does:
AdamW (decay 0.1 on every parameter), linear warmup under the linear LR
scaling rule, MultiStep gamma decay, global-norm clip 0.5.

- The schedule is a plain function of the update count t, from 0 (optax's
  count), run through `LambdaLR` on an optimizer whose base LR is 1, so
  update t takes sched(t) exactly.
- The clip is optax's `clip_by_global_norm` at the config's
  `gradient_clipping`: g * max_norm / |g| when |g| >= max_norm, inside
  the optimizer's step (`ClippedAdamW`), as optax chains it before adamw.
  `torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm.
- `torch.optim.AdamW` takes optax's adamw update,
  p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps). A parameter the forward
  does not reach gets a zero gradient, so that it still decays, as optax
  decays every leaf.

The BatchNorm running statistics are updated in the forward
(`models/common.batchnorm_train`); the JAX step returns them beside the
parameters. Under a process group the step is the global batch's
(`parallel/mesh.py`).
"""

from __future__ import annotations

import torch

from gim_tpu_torch.config import LoFTRConfig, TrainerConfig
from gim_tpu_torch.models.loftr import LoFTRMatcher
from gim_tpu_torch.parallel import mesh
from gim_tpu_torch.train import losses as L


def make_schedule(tcfg: TrainerConfig, world_size: int, batch_size: int,
                  steps_per_epoch: int):
    """LR of update t (t = 0, 1, ...): linear warmup from warmup_ratio * lr
    to lr over the scaled warmup steps, then lr times gamma for each
    milestone (in epochs of `steps_per_epoch` updates) that t has reached
    (t >= boundary)."""
    lr = tcfg.true_lr(world_size, batch_size)
    warmup = tcfg.true_warmup(world_size, batch_size)
    start = tcfg.warmup_ratio * lr
    # a dict's keys, as optax's boundaries_and_scales: one scale a boundary
    boundaries = {int(m * steps_per_epoch) for m in tcfg.scheduler_milestones}

    def schedule(t: int) -> float:
        if t < warmup:                     # optax.linear_schedule
            return (start - lr) * (1 - t / warmup) + lr
        return lr * tcfg.scheduler_gamma ** sum(t >= b for b in boundaries)

    return schedule


class ClippedAdamW(torch.optim.AdamW):
    """optax.chain(clip_by_global_norm(max_norm), adamw(...)): `step`
    clips the gradients by their global norm, then takes AdamW's
    update."""

    def __init__(self, params, max_norm: float, **kw):
        super().__init__(params, **kw)
        self.max_norm = max_norm

    def step(self, closure=None):
        clip_by_global_norm_([p.grad for g in self.param_groups
                              for p in g["params"]], self.max_norm)
        return super().step(closure)


def make_optimizer(params, tcfg: TrainerConfig, world_size: int,
                   batch_size: int, steps_per_epoch: int):
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay on every parameter)
    under `make_schedule`, after the global-norm clip at
    `tcfg.gradient_clipping`. Returns (optimizer, scheduler)."""
    opt = ClippedAdamW(list(params), tcfg.gradient_clipping, lr=1.0,
                       betas=(0.9, 0.999), eps=1e-8,
                       weight_decay=tcfg.adamw_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, make_schedule(tcfg, world_size, batch_size, steps_per_epoch))
    return opt, sched


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm |g| is at
    least max_norm, every gradient becomes (g / |g|) * max_norm. Decided on
    the device, with no host sync. Returns |g|."""
    norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def build_train_model(cfg: LoFTRConfig) -> LoFTRMatcher:
    """The LoFTR matcher in train mode (float32 only: the JAX CLI trains in
    float32)."""
    if cfg.dtype != "float32":
        raise ValueError("gim_loftr trains in float32")
    return LoFTRMatcher(cfg, train_mode=True)


def spv_from_labels(labels: torch.Tensor, label_valid: torch.Tensor,
                    hw_c: tuple[int, int], scale: int) -> dict:
    """The labels' coarse cell pairs for the GT padding: i_ids, j_ids
    (B, G) and valid (B, G)."""
    cells = L.label_cells
    return {"i_ids": cells(labels[..., 0], labels[..., 1], hw_c, scale),
            "j_ids": cells(labels[..., 2], labels[..., 3], hw_c, scale),
            "valid": label_valid}


def loftr_loss(model: LoFTRMatcher, batch: dict, uniform=None, gumbel=None):
    """Forward in train mode and the pseudo-label losses.

    batch: color0/color1 (B, 3, H, W), labels (B, N, 4) resized-frame px,
    label_valid (B, N). The forward runs the reference's train-time coarse
    sampling: GT cell pairs from the labels pad the fine-stage slots (ref
    coarse_matching.py:199-234), with the draws `uniform` and `gumbel`
    (`models/loftr/model.padding_draws` when None). Returns (loss,
    {"loss_c", "loss_f"}): this process's share of the global batch's
    loss (the whole loss outside a process group).
    """
    c = model.cfg
    if not model.train_mode:
        raise ValueError("loftr_loss needs a model built with train_mode")
    B, _, H, W = batch["color0"].shape
    scale = c.resolution[0]
    hw_c = (H // scale, W // scale)
    spv = spv_from_labels(batch["labels"], batch["label_valid"], hw_c, scale)
    out = model(batch["color0"], batch["color1"], spv=spv, uniform=uniform,
                gumbel=gumbel)
    conf_gt = L.coarse_gt_from_labels(batch["labels"], batch["label_valid"],
                                      hw_c, scale)
    loss_c = L.coarse_focal_loss(out["conf_matrix"], conf_gt, c.focal_alpha,
                                 c.focal_gamma, c.pos_weight, c.neg_weight)

    # fine supervision at the coarse grid point
    denom = (c.fine_window_size // 2) * c.resolution[1]
    expec_gt, has_gt = L.fine_gt_from_labels(
        batch["labels"], batch["label_valid"], out["i_ids"],
        out["mkpts1_c"], hw_c, scale, float(denom))
    loss_f = L.fine_l2_std_loss(out["expec_f"], expec_gt,
                                has_gt & out["valid"], c.fine_correct_thr)
    return loss_c + loss_f, {"loss_c": loss_c, "loss_f": loss_f}


def backward(loss: torch.Tensor, optimizer) -> None:
    """loss.backward(); then every parameter of `optimizer` has a gradient
    (zero where the forward does not reach it), summed over the processes
    under a process group: the global batch's gradient."""
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh.in_group():
        mesh.sum_grads_([p.grad for p in params])


def train_step(loss_fn, optimizer, scheduler) -> dict:
    """One update: zero the gradients, `loss_fn()` -> (loss, logs) (the
    forward in train mode, which moves the BatchNorm running statistics,
    and the losses), `backward`, the optimizer's step (global-norm clip,
    AdamW; `make_optimizer`), the schedule. Returns {"loss", **logs},
    detached: the global batch's under a process group, whose update this
    is (each process's values are its shares)."""
    optimizer.zero_grad(set_to_none=False)
    loss, logs = loss_fn()
    backward(loss, optimizer)
    optimizer.step()
    scheduler.step()
    return {k: mesh.global_sum(v) for k, v in
            {"loss": loss, **logs}.items()}


def loftr_train_step(model: LoFTRMatcher, optimizer, scheduler, batch: dict,
                     uniform=None, gumbel=None) -> dict:
    """`train_step` on gim_loftr's losses (`loftr_loss`). Returns {"loss",
    "loss_c", "loss_f"}."""
    return train_step(lambda: loftr_loss(model, batch, uniform, gumbel),
                      optimizer, scheduler)
