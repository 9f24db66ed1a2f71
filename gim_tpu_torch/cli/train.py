"""Training CLI of the PyTorch port (port of `gim_tpu/cli/train.py`).

    python -m gim_tpu_torch.cli.train \
        --weight gim_loftr|gim_dkm|gim_roma|gim_lightglue \
        --labels_root <propagated labels> --video <video> \
        [--img_size 840] [--batch_size 1] [--max_labels 20000] \
        [--max_steps 1000] [--ckpt_dir checkpoints/<weight>] \
        [--device cuda|cpu]

Every head trains on WALK pseudo-labels at the JAX CLI's operating point
(`gim_tpu/cli/train.py:84-117`, `head_config`), in float32 with both TF32
switches off, with AdamW under the reference's LR scaling, warmup,
MultiStep decay and the config's global-norm clip (`train/loop.py`):

- gim_loftr: `LoFTRConfig(max_matches=1024)`, `train/loop.py`;
- gim_dkm: `DKMConfig(upsample_preds=False)` at h_resized = w_resized =
  --img_size, `train/dense_losses.py`;
- gim_roma: `RoMaConfig(upsample_preds=False)` (coarse_res 672, the
  frozen DINOv2 ViT-L/14 in the optimizer as in the JAX step),
  `train/dense_losses.py`;
- gim_lightglue: SuperPoint and LightGlue jointly (the optimizer holds
  both), `train/lightglue_loop.py`.

`--img_size` defaults per head (`DEFAULT_SIZES`). It runs on the GPU
unless `--device cpu` is given, and raises without one.

Data parallel: under torchrun (`torchrun --nproc_per_node N -m
gim_tpu_torch.cli.train ...`) each process takes `--batch_size` pairs and
the update is that of the global batch (`parallel/mesh.py`); rank 0
writes the checkpoints.

Checkpoints: every `--save_interval` steps and at the end,
`<ckpt_dir>/step_XXXXXXXX.ckpt` (torch.save): the model in the reference
layout under 'state_dict' (`weights/port.reference_state_dict`, so
`Matcher.from_checkpoint` loads the file or the directory), plus the
optimizer's and scheduler's state and the step count. A run resumes from
the latest checkpoint in `--ckpt_dir`.
"""

from __future__ import annotations

import argparse
import copy
import os
import queue
import threading
import time

import numpy as np
import torch

from gim_tpu_torch.api import build_model
from gim_tpu_torch.config import GimConfig, LoFTRConfig, replace
from gim_tpu_torch.models.common import init_weights
from gim_tpu_torch.models.dkm.model import DKMMatcher
from gim_tpu_torch.models.roma import RoMaMatcher
from gim_tpu_torch.parallel import mesh
from gim_tpu_torch.train import loop
from gim_tpu_torch.train.dense_losses import dense_train_step
from gim_tpu_torch.train.lightglue_loop import lightglue_train_step
from gim_tpu_torch.weights import port

DEFAULT_SIZES = {"gim_loftr": 840, "gim_lightglue": 1024, "gim_dkm": 672,
                 "gim_roma": 672}
BATCH_KEYS = ("color0", "color1", "labels", "label_valid")


def head_config(weight: str, img_size: int) -> GimConfig:
    """The JAX CLI's configuration of head `weight` at `img_size`
    (`gim_tpu/cli/train.py:84-117`)."""
    cfg = GimConfig(loftr=LoFTRConfig(max_matches=1024))
    if weight == "gim_dkm":
        # the model resolution follows --img_size (README.md:242 trains at
        # 896 x 672), so training runs at the size asked for
        cfg = replace(cfg, dkm=replace(cfg.dkm, upsample_preds=False,
                                       h_resized=img_size,
                                       w_resized=img_size))
    elif weight == "gim_roma":
        cfg = replace(cfg, roma=replace(cfg.roma, upsample_preds=False))
    return cfg


def build_train_model(weight: str, cfg: GimConfig) -> torch.nn.Module:
    """Head `weight`'s model in train mode: gim_lightglue's SuperPoint and
    LightGlue together, as the JAX CLI optimises its full variables."""
    if weight == "gim_loftr":
        return loop.build_train_model(cfg.loftr)
    if weight == "gim_dkm":
        return DKMMatcher(cfg.dkm, train_mode=True)
    if weight == "gim_roma":
        return RoMaMatcher(cfg.roma, train_mode=True)
    if weight == "gim_lightglue":
        return build_model(weight, cfg)
    raise ValueError(f"no training for {weight}")


class Trainer:
    """A head's training state on one device: the model in train mode
    (seeded weights), AdamW over every parameter under its schedule, and
    the update count."""

    def __init__(self, cfg: GimConfig, world_size: int, batch_size: int,
                 steps_per_epoch: int, device: torch.device,
                 generator: torch.Generator | None = None,
                 weight: str = "gim_loftr"):
        self.weight = weight
        self.cfg = cfg
        self.model = build_train_model(weight, cfg)
        init_weights(self.model, generator if generator is not None
                     else torch.Generator().manual_seed(cfg.trainer.seed))
        self.model.to(device)
        self.optimizer, self.scheduler = loop.make_optimizer(
            self.model.parameters(), cfg.trainer, world_size, batch_size,
            steps_per_epoch)
        self.step_count = 0

    def step(self, batch: dict) -> dict:
        """One update on this process's batch (the global batch's update
        under a process group). Returns the global losses."""
        m, opt, sched = self.model, self.optimizer, self.scheduler
        if self.weight == "gim_loftr":
            logs = loop.loftr_train_step(m, opt, sched, batch)
        elif self.weight == "gim_lightglue":
            logs = lightglue_train_step(m, opt, sched, self.cfg, batch)
        else:
            logs = dense_train_step(m, opt, sched, batch)
        self.step_count += 1
        return logs

    def save(self, path: str) -> None:
        port.write_training_checkpoint(path, self.model, self.optimizer,
                                       self.scheduler, self.step_count,
                                       self.weight)

    def load(self, path: str) -> None:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        self.model.load_state_dict(port.checkpoint_state_dict(
            self.weight, ckpt["state_dict"], self.cfg.lightglue.n_layers))
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.scheduler.load_state_dict(ckpt["scheduler"])
        self.step_count = int(ckpt["step"])

    def snapshot(self) -> dict:
        """A copy of everything a step changes: parameters, BatchNorm
        statistics, optimizer and scheduler state, the count."""
        return {"model": {k: v.clone()
                          for k, v in self.model.state_dict().items()},
                "optimizer": copy.deepcopy(self.optimizer.state_dict()),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step_count}

    def restore(self, snap: dict) -> None:
        self.model.load_state_dict(snap["model"])
        self.optimizer.load_state_dict(snap["optimizer"])
        self.scheduler.load_state_dict(snap["scheduler"])
        self.step_count = snap["step"]


def train_loop(trainer: Trainer, batches, max_steps: int, *,
               ckpt_dir: str | None = None, save_interval: int = 200,
               log_interval: int = 20, on_nonfinite: str = "abort",
               max_nonfinite: int = 5, log=print) -> list[dict]:
    """Steps from `trainer.step_count` to `max_steps`, one batch of the
    iterator `batches` each (dicts of tensors on the trainer's device).

    Every step's loss is read on the host. A non-finite loss aborts
    (SystemExit) with "abort"; with "skip" the step is undone (parameters,
    BatchNorm statistics, optimizer and scheduler state, as the JAX CLI
    reverts them) and its batch skipped, until `max_nonfinite` steps in a
    row. Checkpoints every `save_interval` steps and after the last one
    (rank 0 only, into `ckpt_dir` when given). Returns each kept step's
    losses as floats."""
    out = []
    streak = 0
    start = trainer.step_count
    t0 = time.time()
    while trainer.step_count < max_steps:
        batch = next(batches)
        snap = trainer.snapshot() if on_nonfinite == "skip" else None
        logs = {k: float(v) for k, v in trainer.step(batch).items()}
        step = trainer.step_count
        if not np.isfinite(logs["loss"]):
            streak += 1
            detail = " ".join(f"{k}={v:.4g}" for k, v in sorted(logs.items()))
            msg = f"[train] NON-FINITE loss at step {step}: {detail}"
            if on_nonfinite == "abort" or streak > max_nonfinite:
                raise SystemExit(msg + " - aborting")
            log(msg + f" - reverting the update and skipping the batch "
                f"({streak}/{max_nonfinite})")
            trainer.restore(snap)
            continue
        streak = 0
        out.append(logs)
        if step % log_interval == 0:
            extra = " ".join(f"{k} {v:.4f}" for k, v in sorted(logs.items())
                             if k != "loss")
            log(f"[train] step {step} loss {logs['loss']:.4f} ({extra}) "
                f"{time.time() - t0:.1f}s")
        if ckpt_dir and step % save_interval == 0:
            save(trainer, ckpt_dir)
    if ckpt_dir and max_steps > start and max_steps % save_interval:
        save(trainer, ckpt_dir)
    return out


def save(trainer: Trainer, ckpt_dir: str) -> None:
    if mesh.rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        trainer.save(os.path.join(ckpt_dir,
                                  port.checkpoint_name(trainer.step_count)))


def make_batch(dset, rng: np.random.Generator, B: int) -> dict:
    """B samples drawn at random from `dset` (a sample with too few labels
    inside the crops is redrawn), stacked as numpy arrays."""
    samples = []
    while len(samples) < B:
        s = dset[int(rng.integers(0, len(dset)))]
        if s is not None:
            samples.append(s)
    return {k: np.stack([getattr(s, k) for s in samples])
            for k in BATCH_KEYS}


class Prefetch:
    """Batches built by producer threads, one dataset each (numpy's
    Generator is not thread-safe), into a bounded queue: cv2 and numpy
    release the interpreter lock, so decoding and augmenting overlap the
    device's step. `workers=0`: built in the caller's thread."""

    def __init__(self, make_ds, B: int, seed: int, workers: int):
        self.B = B
        self.q: queue.Queue = queue.Queue(maxsize=max(workers, 1) * 2)
        self.stop = threading.Event()
        self.main = (None if workers else
                     (make_ds(seed), np.random.default_rng(seed)))
        self.threads = [threading.Thread(
            target=self._produce, args=(make_ds, seed + 1 + i), daemon=True)
            for i in range(workers)]
        for th in self.threads:
            th.start()

    def _produce(self, make_ds, seed):
        dset, rng = make_ds(seed), np.random.default_rng(seed + 1000)
        while not self.stop.is_set():
            b = make_batch(dset, rng, self.B)
            while not self.stop.is_set():
                try:
                    self.q.put(b, timeout=1.0)
                    break
                except queue.Full:
                    pass

    def __next__(self) -> dict:
        if not self.threads:
            return make_batch(*self.main, self.B)
        return self.q.get()

    def close(self):
        self.stop.set()
        for th in self.threads:
            th.join(timeout=30)


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def trainer_config(args, world: int) -> GimConfig:
    """The JAX CLI's configuration of the head (`head_config`), with its
    LR / warmup / milestone overrides: the canonical quantities are
    rewritten so that true_lr() and true_warmup() come out at the
    requested values."""
    cfg = head_config(args.weight, args.img_size)
    if (args.lr is not None or args.warmup_steps is not None
            or args.milestones is not None):
        t = cfg.trainer
        t = replace(
            t, canonical_bs=world * args.batch_size,
            canonical_lr=(args.lr if args.lr is not None
                          else t.true_lr(world, args.batch_size)),
            warmup_steps=(args.warmup_steps if args.warmup_steps is not None
                          else t.true_warmup(world, args.batch_size)),
            scheduler_milestones=(tuple(args.milestones)
                                  if args.milestones is not None
                                  else t.scheduler_milestones))
        cfg = replace(cfg, trainer=t)
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weight", default="gim_loftr",
                   choices=["gim_loftr", "gim_lightglue", "gim_dkm",
                            "gim_roma"])
    p.add_argument("--labels_root", required=True,
                   help="propagated pseudo-label root")
    p.add_argument("--video", required=True, help="source video (frames)")
    p.add_argument("--img_size", type=int, default=None,
                   help="default per head: loftr 840, lightglue 1024, "
                        "dkm 672, roma 672 (ref README.md:220-246)")
    p.add_argument("--batch_size", type=int, default=1, help="per process")
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--max_labels", type=int, default=20000)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--save_interval", type=int, default=200)
    p.add_argument("--lr", type=float, default=None,
                   help="override the effective LR (bypasses the linear "
                        "scaling rule)")
    p.add_argument("--warmup_steps", type=int, default=None,
                   help="override the effective warmup step count")
    p.add_argument("--milestones", type=int, nargs="+", default=None,
                   help="override the LR-decay milestones, in epochs "
                        "(epoch = one pass over the pair list)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batch-prefetch worker threads (0 = synchronous)")
    p.add_argument("--augmentation", default="dark",
                   choices=["dark", "mobile", "none"],
                   help="photometric augmentation (WALK trains with "
                        "'dark', ref datasets/walk/__init__.py:32)")
    p.add_argument("--on_nonfinite", default="abort",
                   choices=["abort", "skip"],
                   help="'abort' raises on the first non-finite loss, "
                        "'skip' reverts the update and skips the batch "
                        "(aborts after --max_nonfinite in a row)")
    p.add_argument("--max_nonfinite", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from gim_tpu_torch.data.video import FrameCache
    from gim_tpu_torch.data.walk import WalkDataset
    from gim_tpu_torch.utils.device import resolve_device, set_tf32

    device = resolve_device(args.device)
    set_tf32(False)
    mesh.init_from_env(device)
    world, rank = mesh.world_size(), mesh.rank()
    args.img_size = args.img_size or DEFAULT_SIZES[args.weight]
    args.ckpt_dir = args.ckpt_dir or f"checkpoints/{args.weight}"
    cfg = trainer_config(args, world)

    # the frame cache sits beside the label store, not inside it
    cache_dir = os.path.normpath(
        os.path.join(args.labels_root, os.pardir, "_frames"))
    cache = FrameCache(args.video, cache_dir)
    aug = None if args.augmentation == "none" else args.augmentation

    def make_ds(seed):
        return WalkDataset(cache.frame, args.labels_root, args.img_size,
                           args.max_labels, augmentation=aug, seed=seed)

    n_pairs = len(make_ds(0))
    if n_pairs == 0:
        raise SystemExit("no propagated labels found under "
                         f"{args.labels_root}")
    print(f"[train] {args.weight}: {n_pairs} training pairs, {world} "
          f"process(es) on {device.type}")

    trainer = Trainer(cfg, world, args.batch_size, max(n_pairs, 1), device,
                      weight=args.weight)
    latest = port.latest_checkpoint(args.ckpt_dir)
    if latest is not None:
        trainer.load(latest)
        print(f"[train] resumed from step {trainer.step_count}")

    # each process draws its own stream of pairs
    feed = Prefetch(make_ds, args.batch_size,
                    cfg.trainer.seed + 10000 * rank, max(args.prefetch, 0))

    def batches():
        while True:
            yield to_device(next(feed), device)

    try:
        train_loop(trainer, batches(), args.max_steps,
                   ckpt_dir=args.ckpt_dir, save_interval=args.save_interval,
                   log_interval=args.log_interval,
                   on_nonfinite=args.on_nonfinite,
                   max_nonfinite=args.max_nonfinite)
    finally:
        feed.close()
    print(f"[train] done; checkpoints at {args.ckpt_dir}")


if __name__ == "__main__":
    main()
