"""Visual check of WALK training pairs (port of `gim_tpu/cli/walk_viz.py`,
host code, cv2).

Reference surface: `python -m datasets.walk.walk video_list.txt` renders
random training pairs with their pseudo-label matches to dump/walk/
(ref datasets/walk/walk.py:438-516, figure renderer walk/utils.py:16-130).
Here: `python -m gim_tpu_torch.cli.walk_viz --video v.mp4 --labels_root
... [--num 10]`.
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np


def render_pair(rgb0, rgb1, k0, k1, max_draw: int = 300) -> np.ndarray:
    import cv2

    h0, w0 = rgb0.shape[:2]
    h1, w1 = rgb1.shape[:2]
    H = max(h0, h1)
    canvas = np.zeros((H, w0 + w1 + 8, 3), np.uint8)
    canvas[:h0, :w0] = rgb0
    canvas[:h1, w0 + 8:] = rgb1
    sel = np.random.default_rng(0).permutation(len(k0))[:max_draw]
    for i in sel:
        p = tuple(np.round(k0[i]).astype(int))
        q = tuple(np.round(k1[i] + [w0 + 8, 0]).astype(int))
        cv2.line(canvas, p, q, (80, 220, 100), 1, cv2.LINE_AA)
    return canvas


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--labels_root", default="data/walk_labels")
    p.add_argument("--out_dir", default="dump/walk")
    p.add_argument("--num", type=int, default=10)
    args = p.parse_args(argv)

    import cv2

    from gim_tpu_torch.data.video import VideoStreamer

    seq = os.path.splitext(os.path.basename(args.video))[0]
    prop_root = None
    seq_root = join(args.labels_root, seq)
    for d in sorted(os.listdir(seq_root)):
        if d.startswith("propagate"):
            prop_root = join(seq_root, d)
    if prop_root is None:
        raise SystemExit("no propagated labels; run "
                         "gim_tpu_torch.cli.propagate")

    vs = VideoStreamer(args.video)
    os.makedirs(args.out_dir, exist_ok=True)
    files = [f for f in sorted(os.listdir(prop_root)) if f.endswith(".npy")]
    rng = np.random.default_rng(0)
    for f in rng.permutation(files)[:args.num]:
        arr = np.load(join(prop_root, f))
        i0, i1 = arr[0, :2].astype(np.int64).tolist()
        labels = arr[1:]
        fig = render_pair(vs.read(i0), vs.read(i1),
                          labels[:, :2], labels[:, 2:])
        out = join(args.out_dir, f"{seq}_{i0}_{i1}.png")
        cv2.imwrite(out, fig[..., ::-1])
        print(f"[walk_viz] {out} ({len(labels)} labels)")
    vs.close()


if __name__ == "__main__":
    main()
