"""Video -> pseudo-label factory (port of
`gim_tpu/cli/video_preprocessor.py:34-247`).

Reference surface: video_preprocessor.py (per (video, method, skip,
resize) task: gap-sampled frame pairs :103-105, semantic masking of
{person, sky, car} :34-44,312-316 (masked pixels zeroed before matching,
:420-421), the zoom-in round cropping around the previous gim_dkm
no-resize round's match bbox :285-330, the matcher branch :350-511, the
static-match (watermark) removal :514-520, the MAGSAC fundamental filter
at 0.5 px :569-583, labels scaled by vratio back to the true video
resolution :110,545-553, saves of (N, 4) .npy with a rolling index
:545-566, resumable :221-251).

As in the JAX package, the per-pair MAGSAC becomes the fundamental
RANSAC on the card (`data.walk.onchip_fundamental_filter`), the matchers
run through `api.Matcher`, and masking is a pluggable
`segment(rgb) -> bool mask` (`models.semseg.make_segmenter`). Decoding,
`_bounded_resize` (cv2 INTER_AREA) and the matcher's preprocessing stay
on the host. The per-pair body is `label_pair`, which takes decoded
frames and the `match` and `segment` callables, so it also runs where
there is no cv2. Everything on the card unless `--device cpu` / `device=
"cpu"` is given; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import functools
import math
import os
from os.path import join

import numpy as np

# zoom-in round resize bounds: SIFT/GLUE keep native size, dense matchers
# bound to 900x1600 (ref video_preprocessor.py:215-216)
RESIZE_BOUND_DENSE = (900, 1600)


def remove_static_matches(k0: np.ndarray, k1: np.ndarray,
                          thr: float = 1.0) -> np.ndarray:
    """Watermark/logo suppression: a match is static iff BOTH coordinate
    displacements are under 1px (ref video_preprocessor.py:514-517:
    moved = ~((kpts0 - kpts1).abs() < 1).min(dim=1)). Returns keep mask."""
    return np.abs(k0 - k1).max(axis=1) >= thr


def store_name(method: str, skip: int, resize: bool) -> str:
    """Label-store dir name, mirroring the reference's
    'WALK <METHOD> [R] <T|F> [S] <skip>' naming (ref :92-95)."""
    return f"{method}_s{skip}_r{'T' if resize else 'F'}"


def _bounded_resize(rgb: np.ndarray, bound_hw, df: int = 8):
    """get_resized_wh + get_divisible_wh + INTER_AREA resize
    (ref video_preprocessor.py:302-306,592-604). Returns (resized, (h, w),
    (h_new, w_new))."""
    import cv2

    h, w = rgb.shape[:2]
    nh, nw = bound_hw
    scale = min(nh / h, nw / w)
    w_new, h_new = int(round(w * scale)), int(round(h * scale))
    w_new = max(w_new // df, 1) * df
    h_new = max(h_new // df, 1) * df
    out = cv2.resize(rgb, (w_new, h_new), interpolation=cv2.INTER_AREA)
    return out, (h, w), (h_new, w_new)


def _crop_bbox(pts: np.ndarray, hw) -> tuple[int, int, int, int]:
    """floor/ceil bbox of previous-round matches, clipped to the frame
    (ref :294-300)."""
    x0 = max(int(math.floor(pts[:, 0].min())), 0)
    x1 = min(int(math.ceil(pts[:, 0].max())), hw[1])
    y0 = max(int(math.floor(pts[:, 1].min())), 0)
    y1 = min(int(math.ceil(pts[:, 1].max())), hw[0])
    return x0, x1, y0, y1


def label_pair(rgb0: np.ndarray, rgb1: np.ndarray, match, vratio,
               segment=None, crop0=None, crop1=None, min_matches: int = 64,
               pix_thr: float = 0.5, device="cuda", stages=None):
    """The per-pair body of `process_video` (`gim_tpu/cli/
    video_preprocessor.py:172-198`): mask the frames (`segment`), match
    (`match(rgb0, rgb1) -> (k0, k1, conf)` in the frames' pixels), drop
    static matches, filter with the fundamental RANSAC on `device`, map
    back to the video's pixels (through the zoom-in crops `crop0`, `crop1`
    = (scale (1, 2), offset (1, 2)) if given, then `vratio`). Returns
    (labels, n) with the (N, 4) float32 labels ((0, 4) below
    `min_matches`) and n the matcher's count, or None when a mask covers
    a whole frame (the pair is skipped unsaved). `stages`,
    if given, is called with a stage's name after each of "segment",
    "match" and "filter"."""
    from gim_tpu_torch.data.walk import onchip_fundamental_filter

    mark = stages or (lambda _: None)
    if segment is not None:
        m0 = segment(rgb0)
        m1 = segment(rgb1)
        if (~m0).sum() == 0 or (~m1).sum() == 0:
            return None
        rgb0 = rgb0 * (~m0[..., None])
        rgb1 = rgb1 * (~m1[..., None])
        mark("segment")
    k0, k1, conf = match(rgb0, rgb1)
    mark("match")
    n = len(k0)
    if n < min_matches:
        return np.zeros((0, 4), np.float32), n
    keep = remove_static_matches(k0, k1)
    k0, k1 = k0[keep], k1[keep]
    if len(k0) >= 8:
        inl = onchip_fundamental_filter(k0, k1, pix_thr, device=device)
        k0, k1 = k0[inl], k1[inl]
    mark("filter")
    # map back to true video resolution (ref :545-553)
    if crop0 is not None:
        k0 = k0 * crop0[0] + crop0[1]
        k1 = k1 * crop1[0] + crop1[1]
    k0 = k0 * vratio
    k1 = k1 * vratio
    labels = np.concatenate([k0, k1], axis=1).astype(np.float32)
    if len(labels) < min_matches:
        labels = np.zeros((0, 4), np.float32)
    return labels, n


def make_match(method: str, img_size: int = 840, ckpt: str | None = None,
               device="cuda"):
    """`match(rgb0, rgb1) -> (k0, k1, conf)` numpy in the frames' pixels:
    root_sift (cv2 SIFT on the host, matched on `device`), or a head of
    `api.Matcher` on frames preprocessed on the host
    (`data.zeb.preprocess_host`, square canvas and mask)."""
    import torch

    from gim_tpu_torch.api import Matcher
    from gim_tpu_torch.data.zeb import preprocess_host
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if method == "root_sift":
        from gim_tpu_torch.models.root_sift import match_pair_rootsift

        return functools.partial(match_pair_rootsift, device=dev)
    matcher = (Matcher.from_checkpoint(method, ckpt, device=dev) if ckpt
               else Matcher(method, device=dev))

    def match(rgb0, rgb1):
        c0, _, sc0, m0, _ = preprocess_host(rgb0, img_size, 8, True)
        c1, _, sc1, m1, _ = preprocess_host(rgb1, img_size, 8, True)
        t = [torch.from_numpy(np.asarray(a))[None]
             for a in (c0, c1, sc0, sc1, m0, m1)]
        with torch.no_grad():
            return matcher.match(*t).numpy_pair(0)

    return match


def process_video(video_path: str, labels_root: str, method: str = "root_sift",
                  skip: int = 20, img_size: int = 840, ckpt: str | None = None,
                  segment=None, max_pairs: int | None = None,
                  min_matches: int = 64, pix_thr: float = 0.5,
                  resize: bool = False, device="cuda"):
    """One (video, method, skip, resize) task. Writes LabelStore under
    `labels_root/<seq>/<method>_s<skip>_r<T|F>/`. The resize=True round
    requires the gim_dkm resize=False round of the same skip (its matches
    define the zoom-in crops, ref :206-212,285-306)."""
    import cv2

    from gim_tpu_torch.data.video import VideoStreamer
    from gim_tpu_torch.data.walk import LabelStore
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    seq = os.path.splitext(os.path.basename(video_path))[0]
    store = LabelStore(join(labels_root, seq,
                            store_name(method, skip, resize)))
    done = store.pairs()

    cache = None
    if resize:
        cache = LabelStore(join(labels_root, seq,
                                store_name("gim_dkm", skip, False)))
        if not cache.pairs():
            raise SystemExit(
                f"resize round needs the gim_dkm no-resize round first "
                f"({cache.root})")

    vs = VideoStreamer(video_path)
    idxs = vs.frame_indices(skip)
    pairs = list(zip(idxs[:-1], idxs[1:]))
    if max_pairs:
        pairs = pairs[:max_pairs]

    # labels are stored at TRUE video resolution: vratio maps decoded-frame
    # pixels back to capture metadata size (ref :75-77,110)
    cap = cv2.VideoCapture(video_path)
    vwidth, vheight = cap.get(3), cap.get(4)
    cap.release()
    first = vs.read(idxs[0])
    vratio = np.array([[vwidth / first.shape[1],
                        vheight / first.shape[0]]], np.float32)

    match = make_match(method, img_size, ckpt, dev)
    bound = RESIZE_BOUND_DENSE if method in ("gim_dkm", "gim_loftr") \
        else None  # SIFT/GLUE zoom at native size (ref :215-216)

    n_done = 0
    for (i, j) in pairs:
        if (i, j) in done:
            continue
        rgb0 = vs.read(i)
        rgb1 = vs.read(j)

        crop0 = crop1 = None
        if resize:
            pts = cache.load(i, j)
            if pts is None or len(pts) == 0:
                continue
            pt0 = pts[:, :2] / vratio    # cache is at true resolution
            pt1 = pts[:, 2:] / vratio
            xA0, xA1, yA0, yA1 = _crop_bbox(pt0, rgb0.shape[:2])
            xB0, xB1, yB0, yB1 = _crop_bbox(pt1, rgb1.shape[:2])
            if xA1 - xA0 < 32 or yA1 - yA0 < 32 or \
               xB1 - xB0 < 32 or yB1 - yB0 < 32:
                continue
            rgb0 = rgb0[yA0:yA1, xA0:xA1]
            rgb1 = rgb1[yB0:yB1, xB0:xB1]
            b = bound or rgb0.shape[:2]
            rgb0, (hA, wA), (hA_new, wA_new) = _bounded_resize(rgb0, b)
            b = bound or rgb1.shape[:2]
            rgb1, (hB, wB), (hB_new, wB_new) = _bounded_resize(rgb1, b)
            crop0 = (np.array([[wA / wA_new, hA / hA_new]], np.float32),
                     np.array([[xA0, yA0]], np.float32))
            crop1 = (np.array([[wB / wB_new, hB / hB_new]], np.float32),
                     np.array([[xB0, yB0]], np.float32))

        out = label_pair(rgb0, rgb1, match, vratio, segment, crop0, crop1,
                         min_matches, pix_thr, dev)
        if out is None:
            continue
        store.save(i, j, out[0])
        if out[1] < min_matches:
            continue
        n_done += 1
        if n_done % 20 == 0:
            store.flush_index()
            print(f"[video] {seq} {method} s{skip} r{resize}: "
                  f"{n_done} pairs", flush=True)
    store.flush_index()
    vs.close()
    print(f"[video] {seq} {method} s{skip} r{resize}: done "
          f"({n_done} new pairs)")
    return store


def make_segmenter_from_ckpt(encoder_ckpt: str, decoder_ckpt: str | None,
                             device="cuda"):
    """ADE20K semseg masking hook: segment(rgb) -> bool mask of the
    excluded {person, sky, car} classes (ref video_preprocessor.py:34-44).
    `encoder_ckpt` and `decoder_ckpt`: the reference's two mit_semseg
    files, or one converted file (`cli/convert_ckpt.py --model semseg`)
    and None."""
    from gim_tpu_torch.models.semseg import build_segmenter, make_segmenter
    from gim_tpu_torch.weights import port

    if decoder_ckpt is None:
        sd = port.load_converted(encoder_ckpt, "semseg")
    else:
        sd = port.load_semseg_state_dict(encoder_ckpt, decoder_ckpt)
    return make_segmenter(build_segmenter(sd, device=device))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--labels_root", default="data/walk_labels")
    p.add_argument("--method", default="root_sift",
                   choices=["root_sift", "gim_lightglue", "gim_loftr",
                            "gim_dkm"])
    p.add_argument("--skip", type=int, default=20)
    p.add_argument("--img_size", type=int, default=840)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--resize", action="store_true",
                   help="zoom-in round: crop around the gim_dkm no-resize "
                        "round's matches (ref :285-306)")
    p.add_argument("--segment_encoder", default=None,
                   help="ADE20K semseg encoder ckpt, or a converted semseg "
                        "checkpoint alone (enables masking)")
    p.add_argument("--segment_decoder", default=None)
    p.add_argument("--max_pairs", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where matching, masking and RANSAC run "
                        "(no fallback)")
    args = p.parse_args(argv)

    segment = None
    if args.segment_encoder:
        segment = make_segmenter_from_ckpt(args.segment_encoder,
                                           args.segment_decoder, args.device)
    process_video(args.video, args.labels_root, args.method, args.skip,
                  args.img_size, args.ckpt, segment=segment,
                  max_pairs=args.max_pairs, resize=args.resize,
                  device=args.device)


if __name__ == "__main__":
    main()
