"""`cli/convert_ckpt.py` for every model on the CPU: a reference-layout
checkpoint of seeded weights (`weights/port.reference_state_dict`; for
semseg the mit_semseg encoder and decoder files) goes through the CLI;
the converted file read back (`weights/port.load_converted`) and loaded
(`Matcher.from_checkpoint`, `models.semseg.build_segmenter`) gives the
source's parameters exactly. gim_roma is cut in depth (the trunk's
weights take seconds a block to draw on the host), its DINOv2 from the
side file, as the CLI's `--dinov2` gives it.
"""

import pytest
import torch

from gim_tpu_torch.api import Matcher
from gim_tpu_torch.cli import convert_ckpt
from gim_tpu_torch.config import GimConfig, RoMaConfig, replace
from gim_tpu_torch.models import semseg
from gim_tpu_torch.weights import port

TINY_ROMA = dict(coarse_res=56, upsample_res=(112, 112), cls_to_coord_res=8,
                 num_decoder_blocks=1, num_samples=32, dino_depth=1)


@pytest.mark.parametrize("name", ["gim_loftr", "gim_dkm", "gim_lightglue",
                                  "gim_roma"])
def test_convert_every_head(name, tmp_path):
    cfg = GimConfig()
    if name == "gim_roma":
        cfg = replace(cfg, roma=RoMaConfig(**TINY_ROMA))
    src = Matcher(name, cfg, device="cpu",
                  generator=torch.Generator().manual_seed(7))
    ref = port.reference_state_dict(name, src.model)
    argv = ["--model", name, "--ckpt", str(tmp_path / "ref.ckpt"),
            "--out", str(tmp_path / "conv.pt")]
    if name == "gim_roma":                  # the trunk from the hub file
        roma, dino = port.split_roma_state_dict(
            {k[len("model."):]: v for k, v in ref.items()})
        ref = {f"model.{k}": v for k, v in roma.items()}
        torch.save(dino, tmp_path / "dinov2.pth")
        argv += ["--dinov2", str(tmp_path / "dinov2.pth")]
    torch.save({"state_dict": ref}, tmp_path / "ref.ckpt")
    convert_ckpt.main(argv)
    want = src.model.state_dict()
    got = port.load_converted(str(tmp_path / "conv.pt"), name)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    m = Matcher.from_checkpoint(name, str(tmp_path / "conv.pt"), cfg,
                                device="cpu")
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="holds"):
        Matcher.from_checkpoint("gim_loftr" if name != "gim_loftr"
                                else "gim_dkm", str(tmp_path / "conv.pt"),
                                cfg, device="cpu")
    for f in tmp_path.iterdir():      # up to 0.3 GB a file: free the disk
        f.unlink()


def test_convert_semseg(tmp_path):
    src = semseg.build_segmenter(generator=torch.Generator().manual_seed(8),
                                 device="cpu")
    sd = src.state_dict()
    for part in ("encoder", "decoder"):
        torch.save({k[len(part) + 1:]: v for k, v in sd.items()
                    if k.startswith(part + ".") and "num_batches" not in k},
                   tmp_path / f"{part}.pth")
    convert_ckpt.main(["--model", "semseg", "--ckpt",
                       str(tmp_path / "encoder.pth"), "--dinov2",
                       str(tmp_path / "decoder.pth"), "--out",
                       str(tmp_path / "semseg.pt")])
    got = port.load_converted(str(tmp_path / "semseg.pt"), "semseg")
    m = semseg.build_segmenter(got, device="cpu")
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="not a converted"):
        port.load_converted(str(tmp_path / "encoder.pth"), "semseg")
    for f in tmp_path.iterdir():
        f.unlink()
