"""Convert reference torch checkpoints to the port's own checkpoint files
(port of `gim_tpu/cli/convert_ckpt.py`).

`python -m gim_tpu_torch.cli.convert_ckpt --model gim_loftr \
    --ckpt weights/gim_loftr_50h.ckpt --out weights/gim_loftr_50h.pt`

The JAX CLI writes flax msgpack; the port imports no flax, so its output
is a torch file holding the state dict of the port's model
(`weights/port.checkpoint_state_dict`: prefixes stripped, unused keys
dropped, gim_roma's DINOv2 trunk from `--dinov2` merged in), written by
`weights/port.write_converted`. `Matcher.from_checkpoint` loads it as it
is, and `weights/port.load_converted` reads it back. For `semseg`, `--ckpt` is the
encoder's `.pth` and `--dinov2` the decoder's, as in the JAX CLI
(`weights/port.semseg_state_dict`); `models.semseg.build_segmenter` loads
the result.
"""

from __future__ import annotations

import argparse

MODELS = ["gim_lightglue", "gim_loftr", "gim_dkm", "gim_roma", "semseg"]


def convert(model: str, ckpt: str, out: str, dinov2: str | None = None
            ) -> dict:
    """Write the converted checkpoint of `model` to `out`; returns its
    state dict."""
    from gim_tpu_torch.weights import port

    if model not in MODELS:
        raise SystemExit(f"unknown model {model}")
    if model == "semseg":
        if dinov2 is None:
            raise SystemExit("semseg needs the decoder checkpoint (--dinov2)")
        sd = port.load_semseg_state_dict(ckpt, dinov2)
    else:
        raw = port.load_torch_state_dict(ckpt)
        dino = (port.load_dinov2_state_dict(dinov2)
                if model == "gim_roma" and dinov2 else None)
        sd = port.checkpoint_state_dict(model, raw, dinov2_sd=dino)
    port.write_converted(out, model, sd)
    print(f"[convert] wrote {out}")
    return sd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, choices=MODELS)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dinov2", default=None,
                   help="dinov2 ckpt (gim_roma) / decoder ckpt (semseg)")
    args = p.parse_args(argv)
    convert(args.model, args.ckpt, args.out, args.dinov2)


if __name__ == "__main__":
    main()
