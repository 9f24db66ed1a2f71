"""Offline AUC analysis over dump files (port of `gim_tpu/cli/analysis.py`,
host code copied as it is).

The reference's analysis.py:34-141: re-reads
`dump/zeb/[T] {weight} {scene} {version}.txt` files, dedups identifiers,
computes trapezoid AUC@5 deg over max(R_err, t_err) with NaN/inf -> 180,
prints the per-dataset table.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from os.path import join

from gim_tpu_torch.geometry.pose import error_auc_trapezoid

DATASETS = [
    "GL3D", "BlendedMVS", "ETH3DI", "ETH3DO", "KITTI", "RobotcarWeather",
    "RobotcarSeason", "RobotcarNight", "Multi-FoV", "SceneNetRGBD",
    "ICL-NUIM", "GTA-SfM",
]


def read_dump(path: str) -> dict[str, list]:
    with open(path) as f:
        lines = f.readlines()
    head = lines[0].split()
    details = {k: [] for k in head[3:]}
    seen = set()
    for line in lines[1:]:
        x = line.split()
        if not x or x[0] in seen:
            continue
        seen.add(x[0])
        for k, v in zip(head[3:], x[3:]):
            details[k].append(v)
    return details


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="dump/zeb")
    p.add_argument("--wid", required=True)
    p.add_argument("--version", default=None)
    p.add_argument("--sceids", nargs="+", choices=DATASETS, default=None)
    args = p.parse_args(argv)

    files = {}
    for fname in os.listdir(args.dir):
        if os.path.isdir(join(args.dir, fname)) or not fname.endswith(".txt"):
            continue
        parts = fname.rpartition(".txt")[0].split()
        if len(parts) < 4:
            continue
        if parts[1] == args.wid and (args.version is None
                                     or parts[-1] == args.version):
            files[parts[2]] = fname
    files = {k: files[k] for k in DATASETS if k in files}
    sceids = args.sceids or list(files)

    results = {}
    for sceid in sceids:
        det = read_dump(join(args.dir, files[sceid]))
        r = list(map(float, det["R_errs"]))
        t = list(map(float, det["t_errs"]))
        results[sceid] = error_auc_trapezoid(r, t, (5.0,))["auc@5.0"]

    now = datetime.now().strftime("%Y-%m-%d, %H:%M:%S")
    width = 56 + 25 * len(sceids)
    print("=" * width)
    header = f"{now:<25}{'Model':<15} {'Metric':<14} "
    header += "".join(f"{s:<25} " for s in sceids)
    print(header)
    print("-" * width)
    row = f"{' ':<25}{args.wid:<15} {'auc@ 5.0deg':<14} "
    row += "".join(f"{results[s]:<25.18f} " for s in sceids)
    print(row)
    if results:
        print(f"mean auc@5: {sum(results.values()) / len(results):.4f}")
    print("=" * width)
    return results


if __name__ == "__main__":
    main()
