"""3D reconstruction pipeline (port of `gim_tpu/hloc/reconstruction.py`; ref
reconstruction.py:56-136 + hloc/reconstruction.py:15-135 +
hloc/triangulation.py import steps).

Pipeline: exhaustive pairs -> dense (gim_dkm, root_sift) or sparse
(gim_lightglue) matching -> COLMAP database -> two-view fundamental
verification on the card (replacing COLMAP's host RANSAC) -> pycolmap
incremental mapping when available, else the native mapper
(`hloc/mapper.py`) -> the COLMAP text model.

    python -m gim_tpu_torch.hloc.reconstruction --scene_dir scene \
        --model gim_dkm|gim_lightglue|root_sift [--device cuda|cpu] \
        [--ckpt path]

The CLI runs on the card unless `--device cpu` is given, and raises when
the card is asked for and absent. `build_database_arrays` is the database
stage on arrays (image sizes, keypoints, matches), without h5 or cv2.
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np
import torch

from gim_tpu_torch.utils.device import resolve_device

# JAX verifies every pair with PRNGKey(0) (gim_tpu/hloc/reconstruction.py
# :251); here a generator seeded 0 on the device, for every pair
VERIFY_SEED = 0


def geometric_verification_onchip(kpts0, kpts1, matches,
                                  generator: torch.Generator | None = None,
                                  thresh_px: float = 1.0,
                                  num_hypotheses: int = 2048,
                                  device="cuda", noise=None):
    """Fundamental RANSAC on matched keypoints, on `device`. The points are
    padded to a power of two (at least 8), as in the JAX package. The
    uniforms: `noise` (RANSAC's two banks, (1, H, M) and (1, H_lo, M)),
    else drawn from `generator` (default: one seeded VERIFY_SEED on
    `device`). Returns the inlier mask over `matches` rows."""
    from gim_tpu_torch.geometry.ransac import ransac

    dev = resolve_device(device)
    if len(matches) < 8:
        return np.zeros(len(matches), bool)
    p0 = kpts0[matches[:, 0]]
    p1 = kpts1[matches[:, 1]]
    M = 1 << int(np.ceil(np.log2(max(len(p0), 8))))
    pad = M - len(p0)
    p0p = np.pad(p0, ((0, pad), (0, 0))).astype(np.float32)
    p1p = np.pad(p1, ((0, pad), (0, 0))).astype(np.float32)
    valid = np.zeros(M, bool)
    valid[:len(p0)] = True
    gens = None
    if noise is None:
        gens = [generator if generator is not None
                else torch.Generator(dev).manual_seed(VERIFY_SEED)]
    res = ransac(torch.from_numpy(p0p[None]).to(dev),
                 torch.from_numpy(p1p[None]).to(dev),
                 torch.from_numpy(valid[None]).to(dev), thresh_px,
                 model_kind="fundamental", num_hypotheses=num_hypotheses,
                 noise=noise, generators=gens)
    return res.inliers[0, :len(p0)].cpu().numpy()


def build_database_arrays(db_path: str, sizes: dict, kpts: dict,
                          matches: list, shared_camera: bool = True,
                          verify: bool = True, device="cuda"):
    """The COLMAP database from arrays: sizes {name: (w, h)} in image
    order, keypoints {name: (n, 2)} and matches [(name0, name1, (m, 2))]
    in the order to insert them, each pair verified on `device`
    (`geometric_verification_onchip`). Returns {name: image_id}."""
    from gim_tpu_torch.hloc.database import ColmapDB

    db = ColmapDB(db_path)
    image_ids = {}
    cam_id = None
    for name, (w, h) in sizes.items():
        if cam_id is None or not shared_camera:
            # SIMPLE_RADIAL (model 2): f, cx, cy, k
            cam_id = db.add_camera(2, w, h,
                                   np.array([1.2 * max(w, h), w / 2, h / 2,
                                             0.0]))
        image_ids[name] = db.add_image(name, cam_id)
    for name in sizes:
        db.add_keypoints(image_ids[name], kpts[name] + 0.5)
    for n0, n1, m in matches:
        db.add_matches(image_ids[n0], image_ids[n1], m)
        if verify and len(m) >= 8:
            inl = geometric_verification_onchip(kpts[n0], kpts[n1], m,
                                                device=device)
            db.add_two_view_geometry(image_ids[n0], image_ids[n1],
                                     m[inl], config=3)
        else:
            db.add_two_view_geometry(image_ids[n0], image_ids[n1], m,
                                     config=3)
    db.close()
    return image_ids


def build_database(db_path: str, image_dir: str, names: list[str],
                   feature_path: str, match_path: str,
                   shared_camera: bool = True, verify: bool = True,
                   device="cuda"):
    """Create COLMAP db with features + verified matches
    (ref hloc/reconstruction.py:16-58 incl. unique_camera_ids forcing a
    shared camera :51-58): image sizes with cv2 and the h5 files read on
    the host, then `build_database_arrays`."""
    import cv2
    import h5py

    sizes = {}
    for name in names:
        h, w = cv2.imread(join(image_dir, name)).shape[:2]
        sizes[name] = (w, h)
    with h5py.File(feature_path, "r") as fd:
        kpts = {n: fd[n]["keypoints"][...] for n in names}
    matches = []
    with h5py.File(match_path, "r") as fd:
        # names_to_pair keys are 'name0/name1' -> h5 nests them two deep
        for n0 in fd:
            for n1 in fd[n0]:
                grp = fd[n0][n1]
                if "matches" in grp:
                    m = grp["matches"][...]
                else:  # sparse layout: matches0 per-kpt partner
                    m0 = grp["matches0"][...]
                    sel = m0 >= 0
                    m = np.stack([np.nonzero(sel)[0], m0[sel]], axis=1)
                matches.append((n0, n1, m))
    return build_database_arrays(db_path, sizes, kpts, matches,
                                 shared_camera, verify, device)


def incremental_mapping(db_path: str, image_dir: str, out_dir: str,
                        device="cuda"):
    """Incremental SfM, largest model kept (ref
    hloc/reconstruction.py:61-100). Uses pycolmap when present (exact
    reference behavior); otherwise runs the native mapper
    (`hloc/mapper.py`) on `device` and writes the same COLMAP text-model
    artifacts."""
    try:
        import pycolmap
    except ImportError:
        from gim_tpu_torch.hloc.mapper import incremental_mapping_native

        print("[reconstruction] pycolmap not installed - running the "
              "native incremental mapper")
        os.makedirs(out_dir, exist_ok=True)
        return incremental_mapping_native(db_path, out_dir=join(out_dir, "0"),
                                          device=device)
    os.makedirs(out_dir, exist_ok=True)
    maps = pycolmap.incremental_mapping(db_path, image_dir, out_dir)
    if not maps:
        return None
    best = max(maps, key=lambda i: maps[i].num_reg_images())
    return maps[best]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene_dir", required=True,
                   help="dir with images/ subdir")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--model", default="gim_dkm",
                   choices=["gim_dkm", "gim_lightglue", "root_sift"])
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from gim_tpu_torch.api import Matcher
    from gim_tpu_torch.hloc import pipeline as P

    dev = resolve_device(args.device)
    image_dir = join(args.scene_dir, "images")
    out_dir = args.out_dir or join(args.scene_dir, "outputs", args.model)
    os.makedirs(out_dir, exist_ok=True)
    names = P.list_images(image_dir)
    pairs = P.pairs_from_exhaustive(names)
    print(f"[reconstruction] {len(names)} images, {len(pairs)} pairs")

    feature_path = join(out_dir, "features.h5")
    match_path = join(out_dir, "matches.h5")
    matcher = (Matcher.from_checkpoint(args.model, args.ckpt, device=dev)
               if args.ckpt else Matcher(args.model, device=dev))
    if args.model in ("gim_dkm", "root_sift"):
        # root_sift rides the dense path: its matches have no repeatable
        # detector ids either, so they go through the same cell
        # quantization -> canonical-keypoint aggregation (match_dense.py)
        P.match_dense(pairs, image_dir, feature_path, match_path, matcher)
    else:
        P.extract_features(image_dir, names, feature_path, matcher)
        P.match_features(pairs, feature_path, match_path, matcher)

    db_path = join(out_dir, "database.db")
    build_database(db_path, image_dir, names, feature_path, match_path,
                   device=dev)
    print(f"[reconstruction] wrote {db_path}")
    model = incremental_mapping(db_path, image_dir, join(out_dir, "sfm"),
                                device=dev)
    if model is not None:
        print(f"[reconstruction] registered {model.num_reg_images()} images")


if __name__ == "__main__":
    main()
