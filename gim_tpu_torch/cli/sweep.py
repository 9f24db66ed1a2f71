"""The 12-benchmark ZEB sweep (port of `gim_tpu/cli/sweep.py`), the
`TEST_GIM_*.sh` analog.

Reference surface: `sh TEST_GIM_DKM.sh N_GPUS` loops `python test.py
--tests <D>` over all 12 datasets with per-dataset --img_size /
--max_samples (ref TEST_GIM_DKM.sh:1-15), then the user runs check.py and
analysis.py. Here one command does the whole cycle:

  python -m gim_tpu_torch.cli.sweep --weight gim_dkm --version 100h \
      --data_root <root> [--ckpt ...] [--tests GL3D KITTI ...] \
      [--device cuda|cpu]

Per-dataset settings come from the ZebSpec table (img_size 840 by default,
1240 for KITTI, 1600 for ETH3D; MAX_SAMPLES per datasets/*/__init__.py);
a dataset whose data directory is missing is reported and skipped. Batch
16 for gim_lightglue and 1 otherwise (ref TEST_GIM_LIGHTGLUE.sh:3). Then
the consistency check (`cli/check.py`) and the AUC table
(`cli/analysis.py`) over the dump directory. A failed check is reported
and the table still printed, as in the JAX CLI, and then the sweep exits
with the check's code.
"""

from __future__ import annotations

import argparse
import os
from os.path import join


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weight", default="gim_loftr")
    p.add_argument("--version", default="v0")
    p.add_argument("--data_root", default="data")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out_dir", default="dump/zeb")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: 16 for gim_lightglue, 1 otherwise "
                        "(ref TEST_GIM_LIGHTGLUE.sh:3)")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--img_size", type=int, default=None,
                   help="override every dataset's ZebSpec img_size "
                        "(smoke runs; the reference default is per-dataset)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--ransac", default="MAGSAC")
    p.add_argument("--tests", nargs="+", default=None,
                   help="subset of benchmarks (default: all 12)")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--skip_analysis", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="passed to cli.zeb_eval (no fallback)")
    args = p.parse_args(argv)

    from gim_tpu_torch.cli import zeb_eval
    from gim_tpu_torch.data.zeb import BENCHMARKS

    tests = args.tests or list(BENCHMARKS)
    bs = args.batch_size or (16 if args.weight == "gim_lightglue" else 1)

    ran, missing = [], []
    for key in tests:
        spec = BENCHMARKS[key]
        seq_dir = join(args.data_root, "zeb", key.lower())
        if not os.path.isdir(seq_dir):
            missing.append(key)
            print(f"[sweep] {key}: no data at {seq_dir}; skipped")
            continue
        argv_one = ["--weight", args.weight, "--version", args.version,
                    "--tests", key, "--data_root", args.data_root,
                    "--out_dir", args.out_dir, "--batch_size", str(bs),
                    "--dtype", args.dtype, "--ransac", args.ransac]
        if args.ckpt:
            argv_one += ["--ckpt", args.ckpt]
        if args.max_samples:
            argv_one += ["--max_samples", str(args.max_samples)]
        if args.img_size:
            argv_one += ["--img_size", str(args.img_size)]
        if args.overwrite:
            argv_one += ["--overwrite"]
        argv_one += ["--device", args.device]
        print(f"[sweep] {key} (img_size {spec.img_size}, bs {bs})")
        zeb_eval.main(argv_one)
        ran.append(key)

    print(f"[sweep] done: {len(ran)} benchmarks run, "
          f"{len(missing)} skipped ({missing})")
    if not ran or args.skip_analysis:
        return

    from gim_tpu_torch.cli import analysis, check

    failed = None
    try:
        check.main(["--dir", args.out_dir])
    except SystemExit as e:       # reported, the table printed, re-raised
        print(f"[sweep] consistency check failed ({e}); see above")
        failed = e
    analysis.main(["--dir", args.out_dir, "--wid", args.weight,
                   "--version", args.version])
    if failed is not None:
        raise failed


if __name__ == "__main__":
    main()
