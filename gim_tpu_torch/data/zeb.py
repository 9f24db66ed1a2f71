"""ZEB zero-shot benchmark loaders, 12 datasets in one parameterized
loader (port of `gim_tpu/data/zeb.py`, host code copied as it is).

The reference carries 12 near-identical 122-125 line Dataset clones
(ref datasets/{gl3d,gtasfm,multifov,blendedmvs,iclnuim,scenenet,eth3d,kitti,
robotcar}/ — SURVEY §2.3); their only differences are a filename join
pattern, the pair_names extension, and MAX_SAMPLES. Here that collapses to
a spec table.

On-disk layout (reference contract, ref datasets/gl3d/gl3d.py:33-44):
`<data_root>/zeb/<seq>/<pairfile>.txt`, one line per file:
`img0 img1 covis0 covis1 K0(9 floats) K1(9) T_0to1(16)`, with scene_id =
pairfile stem up to the first '_', and images at
`zeb/<seq>/{scene}{join}{name}.png`.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from os.path import join

import numpy as np

from gim_tpu_torch.ops import image as I


@dataclass(frozen=True)
class ZebSpec:
    """Per-benchmark differences (everything else is shared).

    `strip_ext` encodes which reference loaders run
    `pair[i].rpartition('.')[0]` on the raw pair-file name before building
    the image path: GL3D/BlendedMVS (ref datasets/gl3d/gl3d.py:58-62),
    ETH3D (eth3d/eth3d.py:60-64) and KITTI (kitti/kitti.py:60-64) strip;
    GTASfM/MultiFoV/ICLNUIM/SceneNet (gtasfm/gtasfm.py:60-64 and siblings)
    and Robotcar (robotcar/robotcar.py:60-64) use the name verbatim —
    their pair names carry no extension.
    """

    key: str              # CLI/test.py benchmark key
    scene: str            # dump/analysis scene name (LIST_PATH stem)
    join: str             # scene/name join char in image filename
    name_fmt: str         # pair_names format ('{n}', '{n}.png', 'img/{n}.png', ...)
    max_samples: int
    img_size: int = 840   # reference default; KITTI 1240, ETH3D 1600
    strip_ext: bool = False


BENCHMARKS: dict[str, ZebSpec] = {
    # ref test.py:36-49 + datasets/*/__init__.py + TEST_GIM_*.sh sizes
    "GL3D": ZebSpec("GL3D", "GL3D", "_", "{n}", 13, strip_ext=True),
    "BlendedMVS": ZebSpec("BlendedMVS", "BlendedMVS", "_", "{n}", 64,
                          strip_ext=True),
    "GTASfM": ZebSpec("GTASfM", "GTA-SfM", "-", "{n}", 410),
    "MultiFoV": ZebSpec("MultiFoV", "Multi-FoV", "-", "img/{n}.png", 5000),
    "ICLNUIM": ZebSpec("ICLNUIM", "ICL-NUIM", "-", "{n}.jpg", 1250),
    "SceneNet": ZebSpec("SceneNet", "SceneNetRGBD", "-", "{n}.jpg", 30),
    "ETH3DO": ZebSpec("ETH3DO", "ETH3DO", "-", "{n}.JPG", 10000, 1600,
                      strip_ext=True),
    "ETH3DI": ZebSpec("ETH3DI", "ETH3DI", "-", "{n}.JPG", 10000, 1600,
                      strip_ext=True),
    "KITTI": ZebSpec("KITTI", "KITTI", "-", "{n}.png", 685, 1240,
                     strip_ext=True),
    "RobotcarNight": ZebSpec("RobotcarNight", "RobotcarNight", "_", "{n}", 500),
    "RobotcarSeason": ZebSpec("RobotcarSeason", "RobotcarSeason", "_", "{n}", 500),
    "RobotcarWeather": ZebSpec("RobotcarWeather", "RobotcarWeather", "_", "{n}", 500),
}


@dataclass
class ZebPair:
    """One evaluation pair (host-side record)."""

    identifier: str       # '{scene_id}#{name0}#{name1}' (dedup key)
    img_path0: str
    img_path1: str
    covisible0: float
    covisible1: float
    K0: np.ndarray        # (3, 3)
    K1: np.ndarray
    T_0to1: np.ndarray    # (4, 4)


def load_pairs(data_root: str, seq: str, spec: ZebSpec) -> list[ZebPair]:
    """Parse all per-pair txt files of one sequence directory."""
    root = join(data_root, "zeb", seq)
    pairs = []
    lines = []
    for path in sorted(glob.glob(join(root, "*.txt"))):
        scene_id = os.path.basename(path).rpartition(".")[0].split("_")[0]
        with open(path) as f:
            lines.append([scene_id] + f.readline().strip().split())
    for pair in sorted(lines):
        scene_id = pair[0]
        if spec.strip_ext:
            n0 = pair[1].rpartition(".")[0]
            n1 = pair[2].rpartition(".")[0]
        else:
            n0, n1 = pair[1], pair[2]
        name0 = spec.name_fmt.format(n=n0)
        name1 = spec.name_fmt.format(n=n1)
        pairs.append(ZebPair(
            identifier="#".join([scene_id, name0, name1]),
            img_path0=join(root, f"{scene_id}{spec.join}{n0}.png"),
            img_path1=join(root, f"{scene_id}{spec.join}{n1}.png"),
            covisible0=float(pair[3]),
            covisible1=float(pair[4]),
            K0=np.array(pair[5:14], np.float32).reshape(3, 3),
            K1=np.array(pair[14:23], np.float32).reshape(3, 3),
            T_0to1=np.array(pair[23:39], np.float32).reshape(4, 4),
        ))
    return pairs


def load_benchmark(data_root: str, key: str,
                   max_samples: int | None = None,
                   seq: str | None = None) -> list[ZebPair]:
    """All pairs of a benchmark. The reference selects exactly one sequence
    directory per benchmark: `zeb/<benchmark.lower()>` (ref
    datasets/data.py:173-175 `seq_names = [benchmark.lower()]` feeding
    `join('zeb', seq_name)` in each loader). We do the same; for ad-hoc
    roots (synthetic benchmarks) without the canonical dir, a single
    non-canonical dir is accepted, but a root holding SEVERAL dirs is
    refused unless `seq` names one explicitly — scanning them all with one
    spec would silently cross-load other benchmarks (VERDICT round-2 weak
    item 6). Pairs are capped per-sequence at MAX_SAMPLES (ref
    datasets/*/__init__.py TESTS.MAX_SAMPLES)."""
    spec = BENCHMARKS[key]
    cap = max_samples or spec.max_samples
    out = []
    zeb_root = join(data_root, "zeb")
    canonical = key.lower()
    if seq is not None:
        seqs = [seq]
    elif os.path.isdir(join(zeb_root, canonical)):
        seqs = [canonical]
    else:
        seqs = sorted(os.listdir(zeb_root)) if os.path.isdir(zeb_root) else []
        if len(seqs) > 1:
            raise ValueError(
                f"{zeb_root} has no '{canonical}' dir but holds several "
                f"candidate sequences {seqs}; pass seq= (or --seq) to pick "
                "one rather than cross-loading them all")
    for s in seqs:
        pairs = load_pairs(data_root, s, spec)
        out.extend(pairs[:cap])
    return out


def preprocess_host(rgb: np.ndarray, img_size: int, df: int = 8,
                    padding: bool = True):
    """Host-side (cv2) reference `read_images` pipeline
    (ref datasets/utils.py:80-126): the data loader never touches the
    device; on-device preprocessing lives in `ops/image.py`."""
    import cv2

    h, w = rgb.shape[:2]
    w_new, h_new = I.target_wh(w, h, img_size, df)
    color = cv2.resize(rgb, (w_new, h_new))
    gray = cv2.cvtColor(color, cv2.COLOR_RGB2GRAY)
    scale = np.array([w / w_new, h / h_new], np.float32)
    mask = None
    if padding:
        pc = np.zeros((img_size, img_size, 3), color.dtype)
        pc[:h_new, :w_new] = color
        pg = np.zeros((img_size, img_size), gray.dtype)
        pg[:h_new, :w_new] = gray
        mask = np.zeros((img_size, img_size), bool)
        mask[:h_new, :w_new] = True
        color, gray = pc, pg
    color = np.transpose(color, (2, 0, 1)).astype(np.float32) / 255.0
    gray = gray[None].astype(np.float32) / 255.0
    return color, gray, scale, mask, (h_new, w_new)


def load_pair_images(pair: ZebPair, img_size: int, df: int = 8,
                     padding: bool = True):
    """Read + preprocess both images (reference read_images semantics).
    Returns dict of numpy arrays ready for batching."""
    import cv2

    def read(path):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    c0, g0, s0, m0, _ = preprocess_host(read(pair.img_path0), img_size, df,
                                        padding)
    c1, g1, s1, m1, _ = preprocess_host(read(pair.img_path1), img_size, df,
                                        padding)
    return {
        "color0": c0, "color1": c1,
        "gray0": g0, "gray1": g1,
        "scale0": s0, "scale1": s1,
        "mask0": m0, "mask1": m1,
        "K0": pair.K0, "K1": pair.K1, "T_0to1": pair.T_0to1,
        "identifier": pair.identifier,
        "covisible0": pair.covisible0, "covisible1": pair.covisible1,
    }


def batch_pairs(samples: list[dict]) -> dict:
    """Stack host samples into fixed-shape batch arrays."""
    out = {}
    for k in ("color0", "color1", "gray0", "gray1", "scale0", "scale1",
              "K0", "K1", "T_0to1"):
        out[k] = np.stack([s[k] for s in samples])
    if samples[0]["mask0"] is not None:
        out["mask0"] = np.stack([s["mask0"] for s in samples])
        out["mask1"] = np.stack([s["mask1"] for s in samples])
    out["identifier"] = [s["identifier"] for s in samples]
    out["covisible0"] = [s["covisible0"] for s in samples]
    out["covisible1"] = [s["covisible1"] for s in samples]
    return out
