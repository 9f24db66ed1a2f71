"""Batch scheduler for the video -> pseudo-label task matrix (port of
`gim_tpu/cli/process_videos.py`).

Reference surface: process_videos.sh (a yt-dlp download and a flock GPU
lease scheduler over 24 (method, skip, resize) tasks per video,
ref process_videos.sh:34-152). Downloading is out of scope
(`--video_dir` takes videos already on disk); the task matrix and its
resumable order are kept. Tasks run one after the other on the card;
several hosts shard the video list by --shard / --num_shards. Unlike the
JAX scheduler, a failed task is not logged and skipped: it stops the run,
and since every store is resumable, running again continues where it
stopped.
"""

from __future__ import annotations

import argparse
import itertools
import os
from os.path import join

DEFAULT_METHODS = ("root_sift", "gim_lightglue", "gim_loftr", "gim_dkm")
LOW_FPS_SKIPS = (10, 20, 40)    # fps <= 30 (ref process_videos.sh:108-124)
HIGH_FPS_SKIPS = (20, 40, 80)   # fps > 30


def tasks_for(fps: float, methods, resize_round: bool = True) -> list:
    """The (method, skip, resize) tasks of one video: methods x skips x
    resize, 24 for the default methods (ref process_videos.sh:108-124).
    Every resize=False task comes first: the resize round crops around
    the gim_dkm rF matches (ref video_preprocessor.py:206-212)."""
    skips = HIGH_FPS_SKIPS if fps > 30 else LOW_FPS_SKIPS
    resizes = (False, True) if resize_round else (False,)
    return [(m, s, r) for r in resizes
            for m, s in itertools.product(methods, skips)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video_dir", required=True)
    p.add_argument("--labels_root", default="data/walk_labels")
    p.add_argument("--methods", nargs="+", default=list(DEFAULT_METHODS))
    p.add_argument("--img_sizes", type=int, nargs="+", default=[840])
    p.add_argument("--no_resize_round", action="store_true",
                   help="drop the resize=T half of the 24-task matrix "
                        "(ref process_videos.sh:108-124)")
    p.add_argument("--ckpts", nargs="+", default=[],
                   help="method=path entries, e.g. gim_loftr=weights/x.ckpt")
    p.add_argument("--max_pairs", type=int, default=None)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from gim_tpu_torch.cli.video_preprocessor import process_video
    from gim_tpu_torch.data.video import VideoStreamer

    ckpts = dict(e.split("=", 1) for e in args.ckpts)
    videos = sorted(v for v in os.listdir(args.video_dir)
                    if v.endswith((".mp4", ".mkv", ".webm")))
    videos = videos[args.shard::args.num_shards]
    print(f"[scheduler] {len(videos)} videos, methods {args.methods}")

    for vid in videos:
        path = join(args.video_dir, vid)
        vs = VideoStreamer(path)
        fps = vs.fps
        vs.close()
        tasks = tasks_for(fps, args.methods, not args.no_resize_round)
        print(f"[scheduler] {vid}: fps {fps:.0f}, {len(tasks)} tasks")
        for method, skip, resize in tasks:
            process_video(path, args.labels_root, method, skip,
                          args.img_sizes[0], ckpts.get(method),
                          max_pairs=args.max_pairs, resize=resize,
                          device=args.device)


if __name__ == "__main__":
    main()
