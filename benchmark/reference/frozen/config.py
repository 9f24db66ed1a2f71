"""Typed configuration tree (PyTorch port of `gim_tpu/config.py`).

A field-for-field copy of the JAX package's dataclasses, with the same
names and defaults, so one config describes one model in both packages.
The port keeps its own copy and imports nothing of `gim_tpu`.

The JAX package's tree replaces the reference's yacs CfgNode + argparse +
omegaconf triplet (ref trainer/config.py, test.py:133-152, networks/lightglue/models/matchers/
lightglue.py:335) with frozen dataclasses. Defaults mirror the reference's
shipped eval/train configs; citations inline.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SuperPointConfig:
    """ref networks/lightglue/superpoint.py:154-170 + demo conf demo.py:338-349."""
    descriptor_dim: int = 256
    nms_radius: int = 3              # demo.py:341 (default 4, demo uses 3)
    max_num_keypoints: int = 2048    # demo.py:342
    detection_threshold: float = 0.0  # demo.py:343
    remove_borders: int = 4
    force_num_keypoints: bool = True  # demo.py:345
    legacy_sampling: bool = True      # weights trained with broken sampling


@dataclass(frozen=True)
class LightGlueConfig:
    """ref networks/lightglue/models/matchers/lightglue.py:306-340."""
    input_dim: int = 256
    descriptor_dim: int = 256
    num_heads: int = 4
    n_layers: int = 9
    filter_threshold: float = 0.1
    # early-exit / pruning exist in reference but default off (:316-317)
    depth_confidence: float = -1.0
    width_confidence: float = -1.0


@dataclass(frozen=True)
class LoFTRConfig:
    """ref networks/loftr/config.py:1-77."""
    # backbone (ResNet-50 bottleneck FPN, RGB input — backbone/resnet.py:247)
    block_dims: tuple[int, ...] = (64, 128, 196, 256, 512, 1024)
    resolution: tuple[int, int] = (8, 2)
    # coarse transformer
    d_model_c: int = 256
    nhead_c: int = 8
    layer_names_c: int = 4           # 4 x (self, cross)
    attention_c: str = "linear"
    temp_bug_fix: bool = False       # loftr.py:22-24
    # coarse matching
    match_threshold: float = 0.2
    dsmax_temperature: float = 0.1
    border_rm: int = 2
    max_matches: int = 4096          # static cap replacing dynamic selection
    # fine
    d_model_f: int = 128
    nhead_f: int = 8
    layer_names_f: int = 1
    attention_f: str = "linear"
    fine_window_size: int = 5
    # ref networks/loftr/config.py:14 — False for the gim_loftr config
    # (test.py merges only TRAIN_COARSE_PERCENT on top of defaults); the
    # original LoFTR outdoor_ds.ckpt used True but GIM's does not.
    fine_concat_coarse_feat: bool = False
    # training (networks/loftr/config.py:49-68 + configs/outdoor)
    # execution options
    dtype: str = "float32"        # model compute dtype ("bfloat16" for speed)
    fused_matching: bool = False  # fused dual-softmax kernel K1 (eval path)
    # training (networks/loftr/config.py:49-68 + configs/outdoor)
    train_coarse_percent: float = 0.3
    train_pad_num_gt_min: int = 200
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    fine_correct_thr: float = 1.0


@dataclass(frozen=True)
class DKMConfig:
    """ref networks/dkm/models/model_zoo/DKMv3.py:5-60, trainer/lightning.py:32-37."""
    gp_dim: int = 256
    dfn_dim: int = 384
    feat_dim: int = 256
    h_resized: int = 660
    w_resized: int = 880
    upsample_res: tuple[int, int] = (1152, 1536)
    upsample_preds: bool = True
    sample_thresh: float = 0.05
    num_samples: int = 5000
    sample_mode: str = "threshold_balanced"
    dtype: str = "float32"   # conv/refiner compute dtype (GP/flow stay f32)
    # Reference ZEB eval feeds the unpadded rectangle straight into
    # match(), whose internal resize to (h_resized, w_resized) distorts the
    # aspect ratio (ref trainer/lightning.py:134-156, dkm.py:668-671).
    # True = reproduce that protocol (resample only the valid canvas
    # region); False = demo-style aspect-pad (ref demo.py:420-428).
    distort_aspect: bool = True
    # Replicate the reference GP's n>2000 batched-inverse bug in EVAL
    # graphs (ref dkm.py:355-359 broadcasts batch row 0's K_yy^-1 to every
    # row via an empty sigma_noise slice — at the 660x880 ZEB geometry the
    # symmetric B->A half is computed with the A->B row's inverse; the
    # published GIM-DKM numbers include this). Training always uses the
    # correct batched solve. See models/dkm/blocks.py GP.
    gp_inv_bug_compat: bool = True
    # Which ConvRefiner scales exist (ref DKMv3.py:52-111 builds all five).
    # The real model always uses all five; the multichip dry run restricts
    # this to ("16", "1") — one with-local-corr and one without — to keep
    # its cold compile short while still exercising every refiner code
    # path under the mesh.
    refiner_scales: tuple[str, ...] = ("16", "8", "4", "2", "1")


@dataclass(frozen=True)
class RoMaConfig:
    """ref networks/roma/roma.py:1124-1270."""
    coarse_res: int = 672             # 14 * 48 (ref trainer/lightning.py:41
                                      # RoMa(img_size=[672]); demo.py:332)
    upsample_res: tuple[int, int] = (1344, 1344)
    decoder_dim: int = 1024
    cls_to_coord_res: int = 64
    num_decoder_blocks: int = 5
    sample_thresh: float = 0.05
    num_samples: int = 5000
    sample_mode: str = "threshold_balanced"
    upsample_preds: bool = True
    symmetric: bool = True
    attenuate_cert: bool = True
    dtype: str = "float32"   # conv/ViT compute dtype (GP/flow stay f32)
    # see DKMConfig.distort_aspect — RoMa eval shares the adapter
    # (ref trainer/lightning.py:124-130) and distorts the rectangle to its
    # square model resolution.
    distort_aspect: bool = True
    # DINOv2 trunk depth (24 = ViT-L/14, the reference model). Only tests
    # shrink it — full-depth compiles are hour-class on this host.
    dino_depth: int = 24


@dataclass(frozen=True)
class RansacConfig:
    """ref trainer/config.py:44-49 + tools/metrics.py:139."""
    pixel_thr: float = 0.5
    conf: float = 0.99999
    num_hypotheses: int = 2048        # parallel bank replaces adaptive iters
    refine_rounds: int = 3


@dataclass(frozen=True)
class TrainerConfig:
    """ref trainer/config.py:1-66 + test.py:158-165 LR scaling."""
    seed: int = 3407
    canonical_bs: int = 64
    canonical_lr: float = 1e-3
    warmup_steps: int = 4800
    warmup_ratio: float = 0.1
    scheduler_milestones: tuple[int, ...] = (3, 6, 9, 12, 17, 20, 23, 26, 29)
    scheduler_gamma: float = 0.5
    optimizer: str = "adamw"
    adamw_decay: float = 0.1
    gradient_clipping: float = 0.5
    epi_err_thr: float = 5e-4
    pose_geo_model: str = "E"

    def true_lr(self, world_size: int, batch_size: int) -> float:
        """Linear LR scaling rule (ref test.py:158-165)."""
        scaling = world_size * batch_size / self.canonical_bs
        return self.canonical_lr * scaling

    def true_warmup(self, world_size: int, batch_size: int) -> int:
        scaling = world_size * batch_size / self.canonical_bs
        return max(int(self.warmup_steps / max(scaling, 1e-9)), 1)


@dataclass(frozen=True)
class EvalConfig:
    img_size: int = 840
    df: int = 8
    padding: bool = True
    batch_size: int = 1
    max_samples: int = 500


@dataclass(frozen=True)
class GimConfig:
    superpoint: SuperPointConfig = field(default_factory=SuperPointConfig)
    lightglue: LightGlueConfig = field(default_factory=LightGlueConfig)
    loftr: LoFTRConfig = field(default_factory=LoFTRConfig)
    dkm: DKMConfig = field(default_factory=DKMConfig)
    roma: RoMaConfig = field(default_factory=RoMaConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


def replace(cfg, **kwargs):
    """Functional config override (dataclasses.replace passthrough)."""
    return dataclasses.replace(cfg, **kwargs)
