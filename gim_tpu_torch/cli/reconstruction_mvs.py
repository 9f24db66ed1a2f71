"""Dense MVS follow-up for the reconstruction pipeline (port of
`gim_tpu/cli/reconstruction_mvs.py`, copied: shell orchestration only).

The reference finishes 3D reconstruction by shelling out to COLMAP's MVS
stages (ref reconstruction.sh:7-20: image_undistorter ->
patch_match_stereo -> stereo_fusion -> dense.ply). MVS itself is host C++
out of model scope (SURVEY §2.9 pycolmap row); this CLI is the same shell
orchestration with the same directory conventions
(inputs/<scene>/images, outputs/<scene>/<version>/{sparse,dense}),
gated on a `colmap` binary being present.

Usage: python -m gim_tpu_torch.cli.reconstruction_mvs --scene_name room \
           --version gim_dkm [--root .]
Run after `python -m gim_tpu_torch.hloc.reconstruction` has produced the
sparse model.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from os.path import join


def run_mvs(root: str, scene_name: str, version: str,
            colmap_bin: str | None = None, dry_run: bool = False):
    """Returns the list of colmap commands run (or that would run)."""
    colmap = colmap_bin or shutil.which("colmap")
    image_path = join(root, "inputs", scene_name, "images")
    out = join(root, "outputs", scene_name, version)
    cmds = [
        [colmap or "colmap", "image_undistorter",
         "--image_path", image_path,
         "--input_path", join(out, "sparse"),
         "--output_path", join(out, "dense")],
        [colmap or "colmap", "patch_match_stereo",
         "--workspace_path", join(out, "dense")],
        [colmap or "colmap", "stereo_fusion",
         "--workspace_path", join(out, "dense"),
         "--output_path", join(out, "dense", "dense.ply")],
    ]
    if dry_run:
        return cmds
    if colmap is None:
        raise SystemExit(
            "colmap binary not found — MVS is a host C++ dependency "
            "(ref reconstruction.sh:7-20); install COLMAP or use "
            "--dry_run to inspect the commands")
    for cmd in cmds:
        subprocess.run(cmd, check=True)
    return cmds


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene_name", required=True)
    p.add_argument("--version", required=True,
                   help="matcher version dir (e.g. gim_dkm)")
    p.add_argument("--root", default=".")
    p.add_argument("--colmap_bin", default=None)
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    cmds = run_mvs(args.root, args.scene_name, args.version,
                   args.colmap_bin, args.dry_run)
    for c in cmds:
        print("[mvs]", " ".join(c))


if __name__ == "__main__":
    main()
