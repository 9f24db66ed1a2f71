"""Fences of the PyTorch port: gim_tpu_torch and chip_smoke.py import
nothing of JAX or of the JAX package, the port's config mirrors the JAX
package's field for field, and entry points never fall back to the CPU."""

import ast
import dataclasses
import pathlib

import pytest
import torch

import gim_tpu.config as jconfig
import gim_tpu_torch.config as tconfig
from gim_tpu_torch import api

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gim_tpu")


def _port_files():
    files = sorted((ROOT / "gim_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"gim_tpu_torch/train/loop.py", "gim_tpu_torch/parallel/mesh.py",
            "gim_tpu_torch/cli/train.py",
            "gim_tpu_torch/data/walk.py",
            "gim_tpu_torch/train/dense_losses.py",
            "gim_tpu_torch/train/lightglue_loop.py",
            "gim_tpu_torch/ops/sampling.py",
            "gim_tpu_torch/eval/zeb.py",
            "gim_tpu_torch/cli/zeb_eval.py",
            "gim_tpu_torch/cli/sweep.py",
            "gim_tpu_torch/cli/convert_ckpt.py",
            "gim_tpu_torch/native/__init__.py",
            "gim_tpu_torch/models/semseg.py",
            "gim_tpu_torch/cli/video_preprocessor.py",
            "gim_tpu_torch/cli/propagate.py",
            "gim_tpu_torch/cli/process_videos.py",
            "gim_tpu_torch/cli/walk_viz.py",
            "gim_tpu_torch/cli/demo.py"} <= names
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def _dataclasses(mod):
    return {n: c for n, c in vars(mod).items()
            if dataclasses.is_dataclass(c) and isinstance(c, type)}


def test_config_mirrors_jax_package_field_for_field():
    jd, td = _dataclasses(jconfig), _dataclasses(tconfig)
    assert set(jd) == set(td)
    for name in jd:
        jf = [(f.name, f.type) for f in dataclasses.fields(jd[name])]
        tf = [(f.name, f.type) for f in dataclasses.fields(td[name])]
        assert jf == tf, name
        # defaults, nested configs included
        assert dataclasses.asdict(jd[name]()) == dataclasses.asdict(
            td[name]()), name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["Matcher", "from_checkpoint", "match_fn",
                                   "train_cli"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry,
                                                           tmp_path):
    cfg = tconfig.GimConfig(loftr=tconfig.LoFTRConfig(layer_names_c=1))
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "train_cli":
            from gim_tpu_torch.cli import train

            train.main(["--labels_root", str(tmp_path),
                        "--video", str(tmp_path / "v.avi")])
        elif entry == "Matcher":
            api.Matcher("gim_loftr", cfg)
        elif entry == "from_checkpoint":
            api.Matcher.from_checkpoint("gim_loftr",
                                        str(tmp_path / "missing.ckpt"), cfg)
        else:
            api.match_fn("gim_loftr", cfg, api.build_model("gim_loftr", cfg),
                         x, x)


@pytest.mark.parametrize("name", ["gim_lightglue"])
def test_unported_heads_name_their_slice(name, monkeypatch):
    """The last head that named a later slice of the port is ported: it
    builds on the CPU at full width and, as every head, raises without
    CUDA when the card is asked for."""
    m = api.Matcher(name, device="cpu")
    assert {p.device.type for p in m.model.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.Matcher(name)


def test_checkpoint_loads_with_strict_keys(tmp_path):
    """A reference-layout checkpoint (prefixed keys, extra matcher buffers)
    loads through from_checkpoint with strict=True."""
    cfg = tconfig.GimConfig(loftr=tconfig.LoFTRConfig(max_matches=8))
    src = api.Matcher("gim_loftr", cfg, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    sd = {f"matcher.{k}": v for k, v in src.model.state_dict().items()}
    sd["matcher.pos_encoding.pe"] = torch.zeros(1)
    path = tmp_path / "gim_loftr.ckpt"
    torch.save({"state_dict": sd}, path)
    dst = api.Matcher.from_checkpoint("gim_loftr", str(path), cfg,
                                      device="cpu")
    for k, v in src.model.state_dict().items():
        assert torch.equal(v, dst.model.state_dict()[k]), k
