"""Synthetic data: a ZEB-format benchmark and a video (port of
`gim_tpu/data/synthetic.py`, host code copied as it is).

Writes data in the reference layout (`zeb/<seq>/<scene>_<i>_<j>.txt` +
PNGs, ref datasets/gl3d/gl3d.py:33-62) from rendered two-plane scenes:
image1 is image0 composited from two plane-induced homographies
H_i = K (R + t n_i^T / d_i) K^-1 of one rigid (R, t), non-degenerate for
essential-matrix estimation, so match -> RANSAC -> pose -> AUC runs
without a dataset. The video (`write_synthetic_video`) moves a camera
smoothly over the same two-plane scenes, with hard cuts between scenes; it
feeds the training CLI without a download. cv2 is imported inside the
functions that draw.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np


def _texture(rng, H, W):
    import cv2

    img = np.zeros((H, W, 3), np.uint8)
    for _ in range(260):
        c = tuple(int(x) for x in rng.integers(40, 255, 3))
        p = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        cv2.circle(img, p, int(rng.integers(2, 18)), c, -1)
    for _ in range(120):
        c = tuple(int(x) for x in rng.integers(40, 255, 3))
        p0 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        p1 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        cv2.line(img, p0, p1, c, 2)
    return cv2.GaussianBlur(img, (3, 3), 0)


def plane_homography(K, R, t, n, d):
    return K @ (R + np.outer(t, n) / d) @ np.linalg.inv(K)


def make_pair(rng, H=480, W=640):
    import cv2

    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    rvec = rng.uniform(-0.12, 0.12, 3)
    R = cv2.Rodrigues(rvec)[0]
    t = rng.uniform(-0.4, 0.4, 3)
    t[2] = rng.uniform(0.05, 0.2)
    img0 = _texture(rng, H, W)

    # two fronto-ish planes at different depths, split left/right; plane
    # n_u^T X = d with visible points (z > 0) needs d < 0 for these
    # back-tilted normals (n_z ~ -1): physical depths ~4 / ~7.5
    n1 = np.array([0.05, 0.02, -1.0])
    n2 = np.array([-0.03, 0.06, -1.0])
    H1 = plane_homography(K, R, t, n1 / np.linalg.norm(n1), -4.0)
    H2 = plane_homography(K, R, t, n2 / np.linalg.norm(n2), -7.5)
    w1 = cv2.warpPerspective(img0, H1, (W, H), borderMode=cv2.BORDER_REFLECT)
    w2 = cv2.warpPerspective(img0, H2, (W, H), borderMode=cv2.BORDER_REFLECT)
    # composite: plane 1 owns the left half of image0, warped to image1.
    m = np.zeros((H, W), np.uint8)
    m[:, : W // 2] = 255
    m1 = cv2.warpPerspective(m, H1, (W, H))
    img1 = np.where(m1[..., None] > 127, w1, w2)

    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return img0, img1, K, T


def _pose_at(rng_amp, k: int, n_frames: int):
    """Smooth camera trajectory: low-frequency sinusoid per DoF, amplitudes
    drawn once per video so every video explores a different path but stays
    inside the ranges `make_pair` uses for the eval benchmark."""
    ph = rng_amp["phase"]
    fr = rng_amp["freq"]
    s = k / max(n_frames - 1, 1)
    rvec = rng_amp["r_amp"] * np.sin(2 * np.pi * fr[:3] * s + ph[:3])
    t = rng_amp["t_amp"] * np.sin(2 * np.pi * fr[3:6] * s + ph[3:6])
    t[2] = 0.12 + 0.08 * np.sin(2 * np.pi * fr[5] * s + ph[5])
    return rvec, t


def render_frame(img0, K, rvec, t, n1, n2, W, H):
    """Two-plane composite of the base texture under pose (rvec, t): the
    scene model of `make_pair`."""
    import cv2

    R = cv2.Rodrigues(rvec)[0]
    H1 = plane_homography(K, R, t, n1 / np.linalg.norm(n1), -4.0)
    H2 = plane_homography(K, R, t, n2 / np.linalg.norm(n2), -7.5)
    w1 = cv2.warpPerspective(img0, H1, (W, H), borderMode=cv2.BORDER_REFLECT)
    w2 = cv2.warpPerspective(img0, H2, (W, H), borderMode=cv2.BORDER_REFLECT)
    m = np.zeros((H, W), np.uint8)
    m[:, : W // 2] = 255
    m1 = cv2.warpPerspective(m, H1, (W, H))
    return np.where(m1[..., None] > 127, w1, w2)


def write_synthetic_video(path: str, n_frames: int = 2400, fps: float = 30.0,
                          seed: int = 0, H: int = 480, W: int = 640,
                          n_scenes: int = 6):
    """Render a synthetic video: smooth camera trajectories over rigid
    two-plane textured scenes with hard scene cuts every
    n_frames // n_scenes frames (the cuts stand in for an internet video's
    shot changes). Writes an MJPG .avi (a codec cv2 always has)."""
    import cv2

    rng = np.random.default_rng(seed)
    # focal scales with the frame size (520 px at the 640-wide default), so
    # a small frame's per-frame motion is not inflated
    f = 520.0 * W / 640.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    n1 = np.array([0.05, 0.02, -1.0])
    n2 = np.array([-0.03, 0.06, -1.0])
    per = n_frames // n_scenes
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (W, H))
    if not vw.isOpened():
        raise IOError(f"VideoWriter failed to open {path}")
    for _ in range(n_scenes):
        img0 = _texture(rng, H, W)
        amp = {
            "r_amp": rng.uniform(0.06, 0.12, 3),
            "t_amp": rng.uniform(0.2, 0.4, 3),
            "phase": rng.uniform(0, 2 * np.pi, 6),
            "freq": rng.uniform(0.7, 1.6, 6),
        }
        for k in range(per):
            rvec, t = _pose_at(amp, k, per)
            frame = render_frame(img0, K, rvec, t, n1, n2, W, H)
            vw.write(frame[..., ::-1])
    vw.release()
    return path


def write_synthetic_benchmark(root: str, n_pairs: int = 6, seed: int = 0,
                              seq: str = "synth0"):
    """Write a GL3D-layout synthetic sequence under `root`/zeb/`seq`."""
    import cv2

    rng = np.random.default_rng(seed)
    d = join(root, "zeb", seq)
    os.makedirs(d, exist_ok=True)
    scene = "synthetic000"
    for i in range(n_pairs):
        img0, img1, K, T = make_pair(rng)
        n0, n1 = f"{2 * i:08d}", f"{2 * i + 1:08d}"
        cv2.imwrite(join(d, f"{scene}_{n0}.png"), img0[..., ::-1])
        cv2.imwrite(join(d, f"{scene}_{n1}.png"), img1[..., ::-1])
        fields = ([f"{n0}.png", f"{n1}.png", "0.5", "0.5"]
                  + [repr(float(x)) for x in K.reshape(-1)] * 2
                  + [repr(float(x)) for x in T.reshape(-1)])
        with open(join(d, f"{scene}_{i}.txt"), "w") as f:
            f.write(" ".join(fields) + "\n")
    return root
