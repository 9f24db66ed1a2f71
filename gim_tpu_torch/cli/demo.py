"""Single-pair matching demo (port of `gim_tpu/cli/demo.py`).

CLI-compatible with the reference demo (ref demo.py:312-540):
`python -m gim_tpu_torch.cli.demo --model gim_lightglue --img0 a1.png
 --img1 a2.png [--device cuda|cpu]` reads a pair, preprocesses it on the
device (resize of the longest edge, multiples of 8), matches, filters
with the fundamental-matrix RANSAC on the device (threshold 1.0, 2048
hypotheses, in place of cv2 USAC_MAGSAC, ref demo.py:514-518), fits a
homography the same way (threshold 3.0, 1024 hypotheses) and writes
`<a>_<b>_<model>_match.png`, `_warp.png` and `_rect.png` (the figures
are cv2, on the host). The JAX CLI's `PRNGKey(0)` and `PRNGKey(1)`
become generators seeded 0 and 1 on the device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def read_image(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def draw_matches(rgb0, rgb1, k0, k1, inliers) -> np.ndarray:
    """Side-by-side dots + lines figure (reference-style, demo.py:72-148)."""
    import cv2

    h0, w0 = rgb0.shape[:2]
    h1, w1 = rgb1.shape[:2]
    H = max(h0, h1)
    canvas = np.zeros((H, w0 + w1 + 10, 3), np.uint8)
    canvas[:h0, :w0] = rgb0
    canvas[:h1, w0 + 10:] = rgb1
    off = np.array([w0 + 10, 0.0])
    for (p, q, ok) in zip(k0, k1, inliers):
        if not ok:
            continue
        cv2.line(canvas, tuple(np.round(p).astype(int)),
                 tuple(np.round(q + off).astype(int)), (60, 200, 90), 1,
                 lineType=cv2.LINE_AA)
    for (p, q, ok) in zip(k0, k1, inliers):
        cv2.circle(canvas, tuple(np.round(p).astype(int)), 2,
                   (255, 255, 255), -1, lineType=cv2.LINE_AA)
        cv2.circle(canvas, tuple(np.round(q + off).astype(int)), 2,
                   (255, 255, 255), -1, lineType=cv2.LINE_AA)
    return canvas


def warp_figure(rgb0, rgb1, H) -> np.ndarray:
    import cv2

    h1, w1 = rgb1.shape[:2]
    warped = cv2.warpPerspective(rgb0, H, (w1, h1))
    blend = cv2.addWeighted(warped, 0.5, rgb1, 0.5, 0)
    return np.concatenate([rgb1, warped, blend], axis=1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="gim_lightglue",
                        choices=["gim_lightglue", "gim_loftr", "gim_dkm",
                                 "gim_roma", "root_sift"])
    parser.add_argument("--img0", default="assets/demo/a1.png")
    parser.add_argument("--img1", default="assets/demo/a2.png")
    parser.add_argument("--ckpt", default=None,
                        help="reference .ckpt or a converted checkpoint")
    parser.add_argument("--img_size", type=int, default=840)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where matching and RANSAC run (no fallback)")
    args = parser.parse_args(argv)

    import cv2
    import torch

    from gim_tpu_torch.api import Matcher
    from gim_tpu_torch.geometry import ransac as R
    from gim_tpu_torch.ops.image import preprocess_image
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    rgb0 = read_image(args.img0)
    rgb1 = read_image(args.img1)
    pp0 = preprocess_image(rgb0, args.img_size, df=8, padding=False,
                           device=dev)
    pp1 = preprocess_image(rgb1, args.img_size, df=8, padding=False,
                           device=dev)

    if args.ckpt:
        matcher = Matcher.from_checkpoint(args.model, args.ckpt, device=dev)
    else:
        if args.model != "root_sift":
            print("[demo] no --ckpt given: running with random weights "
                  "(pipeline smoke test)")
        matcher = Matcher(args.model, device=dev)

    with torch.no_grad():
        res = matcher.match(pp0.color[None], pp1.color[None])
    k0, k1, conf = res.numpy_pair(0)
    print(f"[demo] {len(k0)} raw matches")

    # robust fitting on the device (reference: cv2 USAC_MAGSAC thr 1.0,
    # demo.py:514)
    fit = R.ransac(res.kpts0[:1], res.kpts1[:1], res.valid[:1], 1.0,
                   model_kind="fundamental", num_hypotheses=2048,
                   generators=[torch.Generator(dev).manual_seed(0)])
    inl_full = fit.inliers[0].cpu().numpy()
    v = res.valid[0].cpu().numpy()
    inliers = inl_full[v]
    print(f"[demo] {int(inliers.sum())} inliers after on-device RANSAC")

    # map matches back to original pixel frames for display
    s0 = pp0.scale.cpu().numpy()
    s1 = pp1.scale.cpu().numpy()
    k0o = k0 * s0[None]
    k1o = k1 * s1[None]

    out_dir = Path(args.out_dir or Path(args.img0).parent)
    stem = f"{Path(args.img0).stem}_{Path(args.img1).stem}_{args.model}"
    fig = draw_matches(rgb0, rgb1, k0o, k1o, inliers)
    cv2.imwrite(str(out_dir / f"{stem}_match.png"), fig[..., ::-1])

    if inliers.sum() >= 4:
        # homography by the same RANSAC on the device (the reference's
        # compute_geom uses host cv2.findHomography)
        pad = torch.from_numpy(v & inl_full)[None].to(dev)
        hk0 = res.kpts0[:1] * pp0.scale
        hk1 = res.kpts1[:1] * pp1.scale
        hfit = R.ransac(hk0, hk1, pad, 3.0, model_kind="homography",
                        num_hypotheses=1024,
                        generators=[torch.Generator(dev).manual_seed(1)])
        Hm = hfit.model[0].cpu().numpy().astype(np.float64)
        if np.isfinite(Hm).all() and abs(Hm[2, 2]) > 1e-9:
            fig2 = warp_figure(rgb0, rgb1, Hm / Hm[2, 2])
            cv2.imwrite(str(out_dir / f"{stem}_warp.png"), fig2[..., ::-1])

    # uncalibrated stereo rectification from the device's F (reference
    # demo.py:218-225 cv2.stereoRectifyUncalibrated + :230-266 warp figure;
    # the reference itself runs this on host cv2)
    if inliers.sum() >= 8:
        F = fit.model[0].cpu().numpy().astype(np.float64)
        if np.isfinite(F).all() and np.abs(F).max() > 0:
            # fit.model lives in the resized frame; move it to the original
            # pixel frame: x_orig = D x_resized with D = diag(sx, sy, 1),
            # so F_orig = D1^-T F D0^-1
            D0 = np.diag([1.0 / s0[0], 1.0 / s0[1], 1.0])
            D1 = np.diag([1.0 / s1[0], 1.0 / s1[1], 1.0])
            Fo = D1.T @ F @ D0
            h0_, w0_ = rgb0.shape[:2]
            h1_, w1_ = rgb1.shape[:2]
            ok, H1, H2 = cv2.stereoRectifyUncalibrated(
                k0o[inliers].reshape(-1, 2), k1o[inliers].reshape(-1, 2),
                Fo, imgSize=(w0_, h0_))
            if ok:
                r0 = cv2.warpPerspective(rgb0, H1, (w0_, h0_))
                r1 = cv2.warpPerspective(rgb1, H2, (w1_, h1_))
                Hh = max(h0_, h1_)
                fig3 = np.zeros((Hh, w0_ + w1_ + 10, 3), np.uint8)
                fig3[:h0_, :w0_] = r0
                fig3[:h1_, w0_ + 10:] = r1
                cv2.imwrite(str(out_dir / f"{stem}_rect.png"),
                            fig3[..., ::-1])
    print(f"[demo] wrote {out_dir}/{stem}_match.png")
    return {"matches": (k0, k1), "inliers": inliers,
            "F": fit.model[0].cpu().numpy()}


if __name__ == "__main__":
    main()
