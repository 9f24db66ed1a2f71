"""hloc pipeline stages: pairing, sparse extract/match, dense match+quantize
(port of `gim_tpu/hloc/pipeline.py`).

Reference surface: hloc/pairs_from_exhaustive.py:12-63,
hloc/extract_features.py (conf gim_superpoint: 2048 kpts, resize 1920,
:29-40), hloc/match_features.py (conf gim_lightglue :24-34),
hloc/match_dense.py (conf gim_dkm :25-40, loop :204-258). Storage stays
h5 (host-side C library, same as reference) so downstream COLMAP tooling
and the reference's own scripts interoperate.

Each stage is split in two: a compute function on arrays, which runs the
matcher on its device and returns numpy (`superpoint_features`,
`lightglue_pair`, `dense_pair`, `aggregate_dense`), and the h5 wrapper
with the JAX package's signature (`extract_features`, `match_features`,
`match_dense`), which reads images with cv2 and writes h5 files; both are
imported inside the wrappers, so a machine without them runs the stages
on arrays. `match_dense` runs gim_dkm with `num_samples` samples without
touching the caller's matcher (the JAX function overwrites its `cfg`).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from gim_tpu_torch.hloc.quantize import (KeypointAggregator,
                                         assign_to_keypoints,
                                         matches_from_ids)

# JAX draws SuperPoint's pad uniforms from PRNGKey(3) for every image
# (gim_tpu/hloc/pipeline.py:73); here a generator seeded 3 on every image
PAD_SEED = 3


def names_to_pair(name0: str, name1: str, separator: str = "/") -> str:
    """ref hloc/utils/parsers.py:51."""
    return separator.join((name0.replace("/", "-"),
                           name1.replace("/", "-")))


def pairs_from_exhaustive(names: list[str]) -> list[tuple[str, str]]:
    """All i<j pairs (ref hloc/pairs_from_exhaustive.py:12-63)."""
    return [(names[i], names[j]) for i in range(len(names))
            for j in range(i + 1, len(names))]


def list_images(image_dir: str) -> list[str]:
    exts = {".jpg", ".jpeg", ".png", ".bmp"}
    return sorted(p for p in os.listdir(image_dir)
                  if Path(p).suffix.lower() in exts)


def _read_rgb(image_dir: str, name: str, masks: dict | None) -> np.ndarray:
    import cv2

    img = cv2.cvtColor(cv2.imread(os.path.join(image_dir, name)),
                       cv2.COLOR_BGR2RGB)
    if masks and name in masks:
        img = img * masks[name][..., None].astype(img.dtype)
    return img


def _lightglue_matcher(matcher, device):
    from gim_tpu_torch.api import Matcher

    return matcher or Matcher("gim_lightglue", device=device)


# ---------------------------------------------------------------------------
# Sparse: SuperPoint extract + LightGlue match
# ---------------------------------------------------------------------------

@torch.inference_mode()
def superpoint_features(matcher, gray, image_hw: tuple[int, int],
                        scale: np.ndarray, pad_noise=None) -> dict:
    """SuperPoint on one padded canvas, on the matcher's device.

    gray: (1, S, S) float in [0, 1] (numpy or tensor); image_hw: the
    content's (h, w) on it; scale: (2,) [w/w', h/h'] to the original
    frame; pad_noise: (1, K, 2) uniforms placing the empty slots (default:
    a generator on the device seeded PAD_SEED). Returns the valid
    keypoints (n, 2) in the original frame, descriptors (D, n) and scores
    (n,), as numpy."""
    from gim_tpu_torch.models.superpoint import extract

    dev = matcher.device
    cfg = matcher.cfg.superpoint
    if pad_noise is None:
        pad_noise = torch.rand(
            (1, cfg.max_num_keypoints, 2), device=dev,
            generator=torch.Generator(dev).manual_seed(PAD_SEED))
    out = extract(matcher.model.superpoint,
                  torch.as_tensor(gray, dtype=torch.float32).to(dev)[None],
                  cfg, torch.tensor([image_hw], dtype=torch.float32,
                                    device=dev), pad_noise.to(dev))
    valid = out["valid"][0].cpu().numpy()
    return {"keypoints": out["keypoints"][0].cpu().numpy()[valid]
            * np.asarray(scale, np.float32)[None],
            "descriptors": out["descriptors"][0].cpu().numpy()[valid].T,
            "scores": out["scores"][0].cpu().numpy()[valid]}


def extract_features(image_dir: str, names: list[str], feature_path: str,
                     matcher=None, max_kpts: int = 2048,
                     resize_max: int = 1920,
                     masks: dict | None = None, device="cuda",
                     pad_noise=None):
    """SuperPoint features -> h5 (ref extract_features.py:176-313,
    gim conf :29-40: nms_radius 3, 2048 kpts, resize_max 1920). `max_kpts`
    is unused, as in the JAX function: the matcher's config sets the
    count. `device` builds the default matcher; `pad_noise` as in
    `superpoint_features`."""
    import h5py

    from gim_tpu_torch.data.zeb import preprocess_host

    matcher = _lightglue_matcher(matcher, device)
    with h5py.File(feature_path, "a") as fd:
        for name in names:
            if name in fd:
                continue
            img = _read_rgb(image_dir, name, masks)
            _, gray, scale, _, hw = preprocess_host(img, resize_max, df=8,
                                                    padding=True)
            f = superpoint_features(matcher, gray, hw, scale, pad_noise)
            grp = fd.create_group(name)
            for k in ("keypoints", "descriptors", "scores"):
                grp.create_dataset(k, data=f[k])
            grp.create_dataset("image_size",
                               data=np.array(img.shape[:2][::-1]))
    return feature_path


def _padded(f: dict, max_kpts: int):
    """A stored feature set padded to `max_kpts` slots: keypoints (K, 2),
    descriptors (K, D), valid (K,), image size (2,) float32."""
    k = f["keypoints"]
    d = f["descriptors"].T
    n = len(k)
    kp = np.zeros((max_kpts, 2), np.float32)
    ds = np.zeros((max_kpts, d.shape[1]), np.float32)
    kp[:n] = k[:max_kpts]
    ds[:n] = d[:max_kpts]
    v = np.zeros(max_kpts, bool)
    v[:min(n, max_kpts)] = True
    return kp, ds, v, np.asarray(f["image_size"]).astype(np.float32)


@torch.inference_mode()
def lightglue_pair(matcher, f0: dict, f1: dict, max_kpts: int = 2048):
    """LightGlue on two stored feature sets (keypoints (n, 2), descriptors
    (D, n), image_size (2,) [w, h]) padded to `max_kpts`, on the matcher's
    device. Returns matches0 (K,) and matching_scores0 (K,) as numpy."""
    dev = matcher.device
    k0, d0, v0, wh0 = _padded(f0, max_kpts)
    k1, d1, v1, wh1 = _padded(f1, max_kpts)
    out = matcher.model.lightglue(
        *(torch.from_numpy(a).to(dev)[None]
          for a in (k0, k1, d0, d1, wh0, wh1, v0, v1)))
    return (out["matches0"][0].cpu().numpy(),
            out["matching_scores0"][0].cpu().numpy())


def match_features(pairs: list[tuple[str, str]], feature_path: str,
                   match_path: str, matcher=None, max_kpts: int = 2048,
                   device="cuda"):
    """LightGlue over stored features -> h5 matches
    (ref match_features.py:163-257)."""
    import h5py

    matcher = _lightglue_matcher(matcher, device)

    def load(fd, name):
        return {k: fd[name][k][...]
                for k in ("keypoints", "descriptors", "image_size")}

    with h5py.File(feature_path, "r") as ffd, \
            h5py.File(match_path, "a") as mfd:
        for name0, name1 in pairs:
            key = names_to_pair(name0, name1)
            if key in mfd:
                continue
            m0, sc = lightglue_pair(matcher, load(ffd, name0),
                                    load(ffd, name1), max_kpts)
            grp = mfd.create_group(key)
            grp.create_dataset("matches0", data=m0)
            grp.create_dataset("matching_scores0", data=sc)
    return match_path


# ---------------------------------------------------------------------------
# Dense: DKM match -> quantized canonical keypoints
# ---------------------------------------------------------------------------

def dense_config(matcher, num_samples: int):
    """The matcher's config with gim_dkm's `num_samples` set (the JAX
    function writes it into the caller's matcher; the port leaves the
    matcher as it is and passes the config to each call)."""
    from gim_tpu_torch.config import replace

    cfg = matcher.cfg
    if matcher.name == "gim_dkm":
        cfg = replace(cfg, dkm=replace(cfg.dkm, num_samples=num_samples))
    return cfg


def dense_pair(matcher, cfg, c0, s0, c1, s1):
    """One pair through the dense matcher on its device: color canvases
    (3, S, S) and scales (2,), numpy or tensors. Returns the valid
    keypoints k0, k1 (n, 2) in the original frames and their scores (n,),
    as numpy."""
    from gim_tpu_torch.api import match_fn

    res = match_fn(matcher.name, cfg, matcher.model,
                   *(torch.as_tensor(a)[None] for a in (c0, c1, s0, s1)),
                   device=matcher.device)
    return res.numpy_pair(0)


def aggregate_dense(raw: dict, pairs: list[tuple[str, str]],
                    cell_size: int = 8, max_error: float = 2.0,
                    max_kps: int = 8192):
    """Endpoint aggregation on the host (ref match_dense.py:204-486).
    raw: {(name0, name1): (k0, k1, scores)} in the order the pairs were
    matched. Returns the canonical keypoints {name: (kpts, score)} and the
    unique matches {(name0, name1): (matches (m, 2), scores (m,))}."""
    agg = KeypointAggregator(cell_size, max_error)
    for n0, n1 in pairs:
        k0, k1, conf = raw[(n0, n1)]
        agg.add(n0, k0, conf)
        agg.add(n1, k1, conf)
    canonical = {name: agg.finalize(name, max_kps)
                 for name in sorted({n for p in pairs for n in p})}
    matches = {}
    for (n0, n1), (k0, k1, conf) in raw.items():
        ids0 = assign_to_keypoints(k0, canonical[n0][0], max_error)
        ids1 = assign_to_keypoints(k1, canonical[n1][0], max_error)
        matches[(n0, n1)] = matches_from_ids(ids0, ids1, conf)
    return canonical, matches


def match_dense(pairs: list[tuple[str, str]], image_dir: str,
                feature_path: str, match_path: str, matcher=None,
                img_size: int = 672, num_samples: int = 8192,
                cell_size: int = 8, max_error: float = 2.0,
                masks: dict | None = None, max_kps: int = 8192,
                device="cuda"):
    """DKM per pair -> endpoint aggregation -> canonical kpts + matches
    (ref match_dense.py:204-486; sample 8192 per
    hloc/matchers/dkm.py:60-152)."""
    import h5py

    from gim_tpu_torch.api import Matcher
    from gim_tpu_torch.data.zeb import preprocess_host

    if matcher is None:
        matcher = Matcher("gim_dkm", device=device)
    cfg = dense_config(matcher, num_samples)

    cache: dict[str, tuple] = {}

    def load(name):
        if name not in cache:
            cache[name] = preprocess_host(_read_rgb(image_dir, name, masks),
                                          img_size, df=8, padding=True)
        return cache[name]

    raw = {}
    for name0, name1 in pairs:
        c0, _, s0, _, _ = load(name0)
        c1, _, s1, _, _ = load(name1)
        raw[(name0, name1)] = dense_pair(matcher, cfg, c0, s0, c1, s1)
    canonical, matches = aggregate_dense(raw, pairs, cell_size, max_error,
                                         max_kps)

    with h5py.File(feature_path, "a") as fd:
        for name, (kpts, score) in canonical.items():
            if name in fd:
                del fd[name]
            grp = fd.create_group(name)
            grp.create_dataset("keypoints", data=kpts)
            grp.create_dataset("score", data=score)

    with h5py.File(match_path, "a") as fd:
        for (n0, n1), (m, sc) in matches.items():
            key = names_to_pair(n0, n1)
            if key in fd:
                del fd[key]
            grp = fd.create_group(key)
            grp.create_dataset("matches", data=m)
            grp.create_dataset("scores", data=sc)
    return feature_path, match_path
