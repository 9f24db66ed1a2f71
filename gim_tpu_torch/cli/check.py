"""Cross-run consistency checker (port of `gim_tpu/cli/check.py`, host
code copied as it is).

The reference's check.py:1-45: asserts all evaluated methods
covered the exact same pair identifiers per dataset — guards against
sampler drift between runs.
"""

from __future__ import annotations

import argparse
import os
from os.path import join


def identifiers(path: str) -> set[str]:
    with open(path) as f:
        lines = f.readlines()[1:]
    return {line.split()[0] for line in lines if line.strip()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="dump/zeb")
    args = p.parse_args(argv)

    by_scene: dict[str, dict[str, set]] = {}
    for fname in sorted(os.listdir(args.dir)):
        if not fname.endswith(".txt"):
            continue
        parts = fname.rpartition(".txt")[0].split()
        if len(parts) < 4:
            continue
        weight, scene = parts[1], parts[2]
        by_scene.setdefault(scene, {})[weight] = identifiers(
            join(args.dir, fname))

    ok = True
    for scene, runs in by_scene.items():
        sets = list(runs.values())
        same = all(s == sets[0] for s in sets)
        ok &= same
        print(f"{scene:>16}: {'Good' if same else 'Bad'} "
              f"({len(runs)} methods, {len(sets[0])} pairs)")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
