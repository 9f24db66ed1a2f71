"""Label propagation CLI (port of `gim_tpu/cli/propagate.py`).

Reference surface: `python -m datasets.walk.propagate video_list.txt`
(ref datasets/walk/propagate.py:13-82) iterates pairs so that
propagation writes chained labels and ledger entries as a side effect.
Here:
`python -m gim_tpu_torch.cli.propagate --video v.mp4 --labels_root ...
 --step 100 [--device cuda|cpu]`
chains the per-skip label stores into long-gap supervision, each pair
filtered by the fundamental RANSAC on the card
(`data.walk.onchip_fundamental_filter`; raises without CUDA unless
`--device cpu`). Frames are only counted (cv2, on the host).
"""

from __future__ import annotations

import argparse
import functools
import os
import re
from os.path import join


def discover_sources(seq_root: str) -> dict[int, list]:
    """Find per-skip label stores under one sequence dir. Factory store
    names end `_s<skip>_r{T|F}` (cli.video_preprocessor.store_name,
    mirroring ref 'WALK <METHOD> [R] <T|F> [S] <skip>')."""
    from gim_tpu_torch.data.walk import LabelStore

    sources: dict[int, list[LabelStore]] = {}
    for d in sorted(os.listdir(seq_root)):
        m = re.search(r"_s(\d+)_r[TF]$", d)
        if not m:
            continue
        skip = int(m.group(1))
        sources.setdefault(skip, []).append(LabelStore(join(seq_root, d)))
    return sources


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--labels_root", default="data/walk_labels")
    p.add_argument("--step", type=int, default=100,
                   help="frame gap of the propagated training pairs")
    p.add_argument("--skips", type=int, nargs="+", default=[10, 20, 40])
    p.add_argument("--min_final_matches", type=int, default=64)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the fundamental RANSAC runs (no fallback)")
    args = p.parse_args(argv)

    from gim_tpu_torch.data.video import VideoStreamer
    from gim_tpu_torch.data.walk import (PropagationConfig, Propagator,
                                         onchip_fundamental_filter)
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    seq = os.path.splitext(os.path.basename(args.video))[0]
    seq_root = join(args.labels_root, seq)
    if not os.path.isdir(seq_root):
        raise SystemExit(f"no label sources under {seq_root}; run "
                         "gim_tpu_torch.cli.video_preprocessor first")

    sources = discover_sources(seq_root)
    if not sources:
        raise SystemExit(f"no per-skip label stores found in {seq_root}")
    print(f"[propagate] sources: "
          f"{ {k: len(v) for k, v in sources.items()} }")

    vs = VideoStreamer(args.video)
    cfg = PropagationConfig(skips=tuple(sorted(args.skips)),
                            min_final_matches=args.min_final_matches)
    prop = Propagator(sources, vs.size[0], cfg, join(seq_root, "propagate"))
    filt = functools.partial(onchip_fundamental_filter, device=dev)

    idxs = vs.frame_indices(args.step)
    pairs = list(zip(idxs[:-1], idxs[1:]))
    ok = 0
    for i0, i1 in pairs:
        out = prop.propagate_pair(i0, i1, ransac_filter=filt)
        if out is not None:
            ok += 1
    print(f"[propagate] {ok}/{len(pairs)} pairs propagated "
          f"-> {prop.out_root}")


if __name__ == "__main__":
    main()
