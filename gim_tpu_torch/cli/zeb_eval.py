"""ZEB benchmark evaluation CLI (port of `gim_tpu/cli/zeb_eval.py`).

The reference's surface (test.py:64-128):
`python -m gim_tpu_torch.cli.zeb_eval --weight gim_loftr --version 50h
 --tests GL3D --data_root <root> [--img_size 840] [--batch_size 1]
 [--max_samples N] [--device cuda|cpu]`
writes `dump/zeb/[T] {weight} {scene:>15} {version}.txt` and prints the
aggregate AUC. `--synthetic` writes a small two-plane benchmark first (no
dataset download). It runs on the GPU unless `--device cpu` is given,
and raises without one. Under torchrun each process evaluates its share
of the pairs (`parallel.mesh.process_local_pairs`), the rows meet
through the process group's store, and rank 0 writes the dump:
`torchrun --nproc_per_node 2 -m gim_tpu_torch.cli.zeb_eval ...`.
With `GIM_TPU_TRACE=1` the evaluation runs under `utils/profiling.trace`,
which writes a `torch.profiler` trace holding the port's spans to
`GIM_TPU_TRACE_DIR`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_matcher(weight: str, ckpt: str | None, img_size: int,
                  dtype: str = "float32", device: str = "cuda"):
    """Returns match(batch) -> MatchResult on `device`. On CUDA gim_loftr
    takes the fused dual-softmax matching (kernel K1), as the JAX package
    does on the TPU. `dtype` applies to gim_loftr, gim_dkm and gim_roma,
    as in the JAX CLI; gim_lightglue runs in float32."""
    import torch

    from gim_tpu_torch.api import Matcher
    from gim_tpu_torch.config import GimConfig, replace as cfg_replace
    from gim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if weight == "root_sift":
        matcher = Matcher("root_sift", device=dev)

        def match(batch):
            return matcher.match(batch["color0"], batch["color1"],
                                 batch["scale0"], batch["scale1"])

        return match

    cfg = GimConfig()
    if dtype != "float32":
        for head in ("loftr", "dkm", "roma"):
            cfg = cfg_replace(cfg, **{head: cfg_replace(getattr(cfg, head),
                                                        dtype=dtype)})
    # the reference keeps all mutual matches above threshold; the static
    # cap scales with the coarse-cell count so KITTI-1240 / ETH3D-1600
    # runs do not truncate: ~840px -> 8192, 1240 -> 16384
    cells = (img_size // 8) ** 2
    cap = 4096
    while cap < cells // 2 and cap < 16384:
        cap *= 2
    cfg = cfg_replace(cfg, loftr=cfg_replace(
        cfg.loftr, max_matches=cap, fused_matching=dev.type == "cuda"))
    if ckpt:
        matcher = Matcher.from_checkpoint(weight, ckpt, cfg, device=dev)
    else:
        print(f"[zeb_eval] WARNING: no --ckpt; {weight} runs with random "
              "weights (harness validation only)")
        matcher = Matcher(weight, cfg, device=dev)

    def match(batch):
        return matcher.match(batch["color0"], batch["color1"],
                             batch["scale0"], batch["scale1"],
                             batch.get("mask0"), batch.get("mask1"))

    return match


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weight", default="root_sift",
                   choices=["gim_roma", "gim_dkm", "gim_loftr",
                            "gim_lightglue", "root_sift"])
    p.add_argument("--version", default="v0")
    p.add_argument("--tests", default="GL3D")
    p.add_argument("--data_root", default="data")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--out_dir", default="dump/zeb")
    p.add_argument("--padding", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="square-canvas padding + mask (ref datasets/utils.py"
                        ":56-72); --no-padding feeds the bare resized frame")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where matching and RANSAC run (no fallback)")
    p.add_argument("--seq", default=None,
                   help="explicit sequence dir under <data_root>/zeb "
                        "(required when the root holds several ad-hoc dirs)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic two-plane benchmark first")
    p.add_argument("--synthetic_pairs", type=int, default=24,
                   help="pair count for --synthetic (AUC over a handful "
                        "of pairs is too quantized to support claims)")
    p.add_argument("--overwrite", action="store_true",
                   help="re-run even if the dump file already exists")
    p.add_argument("--ransac", default="MAGSAC",
                   choices=["RANSAC", "FAST", "MAGSAC", "PROSAC", "DEFAULT",
                            "ACCURATE", "PARALLEL"],
                   help="RANSAC-zoo preset (ref test.py:51-59) mapped onto "
                        "the on-device solver")
    args = p.parse_args(argv)

    from gim_tpu_torch.data import zeb as Z
    from gim_tpu_torch.eval import zeb as E
    from gim_tpu_torch.geometry.pose import error_auc_trapezoid
    from gim_tpu_torch.parallel.mesh import (init_from_env,
                                             process_local_pairs, rank,
                                             world_size)
    from gim_tpu_torch.utils.device import resolve_device
    from gim_tpu_torch.utils.profiling import trace

    dev = resolve_device(args.device)     # no CUDA and no --device cpu: raise
    init_from_env(dev, backend="gloo")    # under torchrun: join its group

    # skip-if-dump-exists (ref test.py:224-230)
    spec = Z.BENCHMARKS[args.tests]
    existing = E.dump_path(args.out_dir, args.weight, spec.scene,
                           args.version)
    if os.path.exists(existing) and not args.overwrite:
        print(f"[zeb_eval] {existing} exists; skipping "
              "(pass --overwrite to re-run)")
        return None

    if args.synthetic:
        import tempfile

        from gim_tpu_torch.data.synthetic import write_synthetic_benchmark

        args.data_root = tempfile.mkdtemp(prefix="gim_tpu_torch_synth_")
        write_synthetic_benchmark(args.data_root,
                                  n_pairs=args.synthetic_pairs)
        print(f"[zeb_eval] synthetic benchmark at {args.data_root}")

    img_size = args.img_size or spec.img_size
    pairs = Z.load_benchmark(args.data_root, args.tests, args.max_samples,
                             seq=args.seq)
    if not pairs:
        raise SystemExit(f"no pairs found under {args.data_root}/zeb")
    # across processes (torchrun): the pair list sharded by process, the
    # padded repeats at the tail dropped by the dedup after the gather
    n_proc, pid = world_size(), rank()
    if n_proc > 1:
        E.barrier_multihost("zeb_eval_start")
        pairs = process_local_pairs(pairs)
    print(f"[zeb_eval] {len(pairs)} pairs (proc {pid}/{n_proc}), "
          f"img_size {img_size}, device {args.device}")

    match = build_matcher(args.weight, args.ckpt, img_size, args.dtype,
                          args.device)

    def batches():
        B = args.batch_size
        for i in range(0, len(pairs), B):
            chunk = pairs[i:i + B]
            while len(chunk) < B:  # pad; dedup drops repeats
                chunk.append(chunk[-1])
            yield Z.batch_pairs([Z.load_pair_images(c, img_size, 8,
                                                    args.padding)
                                 for c in chunk])

    n_hyp, use_conf = E.RANSAC_ZOO[args.ransac]
    t0 = time.time()
    with trace("zeb_eval"):          # GIM_TPU_TRACE=1: the port's spans
        rows = E.evaluate(match, batches(), num_hypotheses=n_hyp,
                          use_conf=use_conf)
    dt = time.time() - t0
    rows = E.gather_rows_multihost(rows)
    rows_u = E.dedup_rows(rows)
    print(f"[zeb_eval] {len(rows_u)} unique pairs in {dt:.1f}s "
          f"({len(rows_u) / dt:.2f} pairs/s)")

    if pid == 0:
        path = E.write_dump(rows, args.out_dir, args.weight, spec.scene,
                            args.version)
        print(f"[zeb_eval] wrote {path}")

    aucs = error_auc_trapezoid([r["R_errs"] for r in rows_u],
                               [r["t_errs"] for r in rows_u], (5.0,))
    prec = np.mean([np.mean(r["epi_errs"] < 5e-4) if len(r["epi_errs"])
                    else 0.0 for r in rows_u])
    print(f"[zeb_eval] {spec.scene}: auc@5 {aucs['auc@5.0']:.4f}  "
          f"mean Bef.Prec {prec:.4f}")
    return aucs


if __name__ == "__main__":
    main()
