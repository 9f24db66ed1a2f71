"""WALK training data and the training CLI of gim_tpu_torch, on the CPU.

The host-side data modules are copies of the JAX package's: the same
seeded inputs give equal arrays (`dark_aug`, `mobile_aug`, `WalkDataset`
with and without a seeded photometric augmentation, the synthetic video's
decoded frames). The CLI trains gim_loftr (full width, seeded weights) on a
synthetic 8-frame 96 x 128 video with fabricated propagated labels at
--img_size 64: 2 steps, then a resume to 4; the step-4 checkpoint loads
through `Matcher.from_checkpoint`, from the file and from the directory.
It trains gim_dkm, gim_roma and gim_lightglue the same way (gim_roma and
gim_lightglue cut in depth and keypoints for the CPU), each checkpoint in
the reference layout and loading through `Matcher.from_checkpoint`.
Without `--device cpu` and without CUDA the CLI raises, for every head. The loop's
non-finite guard undoes a step exactly (equal to a run that never took
it) with "skip", and stops with "abort".
"""

import os

import numpy as np
import pytest
import torch

from gim_tpu.data import augment as jaug
from gim_tpu.data import walk as jwalk
from gim_tpu.data.synthetic import write_synthetic_video as j_write_video
from gim_tpu_torch.api import Matcher
from gim_tpu_torch.cli import train as TR
from gim_tpu_torch.config import GimConfig, LoFTRConfig, replace
from gim_tpu_torch.data import augment as taug
from gim_tpu_torch.data import walk as twalk
from gim_tpu_torch.data.synthetic import write_synthetic_video
from gim_tpu_torch.data.video import FrameCache, VideoStreamer


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's steps: the suite runs one
    worker process a core, and torch's default of one thread a core makes
    each of the many small operations of a training step wait for threads
    the other workers hold (measured: 10-30x slower in the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(path):
    vs = VideoStreamer(path)
    out = [vs.read(i) for i in range(vs.n_frames)]
    vs.close()
    return out


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    path = str(d / "v.avi")
    write_synthetic_video(path, n_frames=8, n_scenes=1, seed=3, H=96, W=128)
    return path


def _fabricate_propagated_pairs(root, frames, n_pairs=3):
    """Propagated-label files in the layout the propagation writes (header
    row [i0 i1 i0 i1], then (N, 4) labels), as tests/test_learned_loop.py
    makes them."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    H, W = frames[0].shape[:2]
    for k in range(n_pairs):
        i0, i1 = 2 * k, 2 * k + 1
        pts0 = rng.uniform([0, 0], [W - 1, H - 1], (200, 2))
        labels = np.concatenate([pts0, pts0 + rng.normal(0, 1, (200, 2))],
                                axis=1).astype(np.float32)
        header = np.array([[i0, i1, i0, i1]], np.float32)
        np.save(os.path.join(root, f"{i0}_{i1}.npy"),
                np.concatenate([header, labels], axis=0))


def test_synthetic_video_equals_jax_packages(video, tmp_path):
    jpath = str(tmp_path / "j.avi")
    j_write_video(jpath, n_frames=8, n_scenes=1, seed=3, H=96, W=128)
    a, b = _frames(video), _frames(jpath)
    assert len(a) == len(b) == 8 and a[0].shape == (96, 128, 3)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("name", ["dark_aug", "mobile_aug"])
def test_photometric_augmentation_equals_jax_packages(name, video):
    img = _frames(video)[0]
    for seed in range(3):
        got = getattr(taug, name)(img, np.random.default_rng(seed))
        want = getattr(jaug, name)(img, np.random.default_rng(seed))
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("augmented", [False, True])
def test_walk_dataset_equals_jax_packages(augmented, video, tmp_path):
    frames = _frames(video)
    prop = str(tmp_path / "propagate")
    _fabricate_propagated_pairs(prop, frames)
    kw = dict(img_size=64, max_labels=128, augmentation=None, seed=5)
    got_ds = twalk.WalkDataset(frames.__getitem__, prop, **kw)
    want_ds = jwalk.WalkDataset(frames.__getitem__, prop, **kw)
    if augmented:      # the CLI's augmentor is unseeded: seed one here
        for ds in (got_ds, want_ds):
            rng = np.random.default_rng(11)
            ds.augment = lambda img, rng=rng: taug.dark_aug(img, rng)
    assert len(got_ds) == len(want_ds) == 3
    for idx in (0, 1, 2, 1):
        got, want = got_ds[idx], want_ds[idx]
        assert (got is None) == (want is None)
        if got is None:
            continue
        for k in ("color0", "color1", "labels", "label_valid"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        assert got.labels.shape == (128, 4) and got.color0.shape == (3, 64,
                                                                      64)


def test_label_store_round_trip(tmp_path):
    store = twalk.LabelStore(str(tmp_path / "s"))
    lab = np.arange(12, dtype=np.float32).reshape(3, 4)
    store.save(3, 13, lab)
    store.flush_index()
    again = twalk.LabelStore(str(tmp_path / "s"))
    assert again.pairs() == {(3, 13)}
    np.testing.assert_array_equal(again.load(3, 13), lab)
    assert again.load(0, 1) is None


def test_frame_cache_reads_each_frame_once(video, tmp_path):
    cache = FrameCache(video, str(tmp_path / "frames"), mem_frames=2)
    want = _frames(video)
    for i in (0, 1, 2, 0, 5):
        np.testing.assert_array_equal(cache.frame(i), want[i])
    assert sorted(os.listdir(tmp_path / "frames")) == [
        "0.png", "1.png", "2.png", "5.png"]


def test_train_cli_trains_saves_resumes_and_loads(video, tmp_path, capsys):
    prop = str(tmp_path / "propagate")
    _fabricate_propagated_pairs(prop, _frames(video))
    ckpt = str(tmp_path / "ckpt")
    common = ["--weight", "gim_loftr", "--labels_root", prop,
              "--video", video, "--img_size", "64", "--batch_size", "1",
              "--max_labels", "128", "--lr", "1e-4", "--warmup_steps", "1",
              "--ckpt_dir", ckpt, "--save_interval", "2",
              "--log_interval", "1", "--augmentation", "none",
              "--prefetch", "1", "--device", "cpu"]
    TR.main(common + ["--max_steps", "2"])
    assert sorted(os.listdir(ckpt)) == ["step_00000002.ckpt"]
    TR.main(common + ["--max_steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "[train] step 4 loss" in out
    assert sorted(os.listdir(ckpt)) == ["step_00000002.ckpt",
                                        "step_00000004.ckpt"]

    saved = torch.load(os.path.join(ckpt, "step_00000004.ckpt"),
                       weights_only=False)
    assert saved["step"] == 4 and saved["scheduler"]["last_epoch"] == 4
    assert all(k.startswith("model.") for k in saved["state_dict"])
    cfg = GimConfig(loftr=LoFTRConfig(max_matches=64))
    for path in (ckpt, os.path.join(ckpt, "step_00000004.ckpt")):
        m = Matcher.from_checkpoint("gim_loftr", path, cfg, device="cpu")
        for k, v in m.model.state_dict().items():
            assert torch.equal(v, saved["state_dict"]["model." + k]), k
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    r = m.match(x, x)
    assert torch.isfinite(r.kpts1).all()


def test_train_cli_raises_without_cuda_and_for_later_heads(monkeypatch,
                                                           video, tmp_path):
    """Every head is ported: on the CPU each one gets as far as the label
    store (empty here); without CUDA each one raises unless given
    --device cpu."""
    args = ["--labels_root", str(tmp_path / "empty"), "--video", video]
    os.makedirs(tmp_path / "empty")
    for weight in TR.DEFAULT_SIZES:
        with pytest.raises(SystemExit, match="no propagated labels"):
            TR.main(args + ["--weight", weight, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for weight in TR.DEFAULT_SIZES:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TR.main(args + ["--weight", weight])


def small_head_config(weight: str, img_size: int) -> GimConfig:
    """The CLI's configuration of each head, cut for the CPU where it would
    take minutes: gim_roma at coarse_res 56 with 2 DINOv2 blocks and 1
    decoder block, gim_lightglue at 128 keypoints. Widths stay."""
    cfg = HEAD_CONFIG(weight, img_size)
    if weight == "gim_roma":
        cfg = replace(cfg, roma=replace(cfg.roma, coarse_res=56,
                                        dino_depth=2, num_decoder_blocks=1))
    if weight == "gim_lightglue":
        cfg = replace(cfg, superpoint=replace(cfg.superpoint,
                                              max_num_keypoints=128))
    return cfg


HEAD_CONFIG = TR.head_config


@pytest.mark.parametrize("weight", ["gim_dkm", "gim_roma", "gim_lightglue"])
def test_train_cli_trains_each_head_and_its_checkpoint_loads(
        weight, video, tmp_path, monkeypatch, capsys):
    """`cli.train --device cpu` for each later head (`small_head_config`)
    on the synthetic store at --img_size 64: 2 steps with a save at 1, a
    resume to 3; the step-3 checkpoint holds the reference layout and
    loads through `Matcher.from_checkpoint`, which matches a pair."""
    monkeypatch.setattr(TR, "head_config", small_head_config)
    prop = str(tmp_path / "propagate")
    _fabricate_propagated_pairs(prop, _frames(video))
    ckpt = str(tmp_path / "ckpt")
    common = ["--weight", weight, "--labels_root", prop, "--video", video,
              "--img_size", "64", "--max_labels", "128", "--lr", "1e-4",
              "--warmup_steps", "1", "--ckpt_dir", ckpt,
              "--save_interval", "1", "--log_interval", "1",
              "--augmentation", "none", "--prefetch", "0", "--device", "cpu"]
    TR.main(common + ["--max_steps", "2"])
    TR.main(common + ["--max_steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "[train] step 3 loss" in out
    assert sorted(os.listdir(ckpt)) == [f"step_0000000{i}.ckpt"
                                        for i in (1, 2, 3)]
    saved = torch.load(os.path.join(ckpt, "step_00000003.ckpt"),
                       weights_only=False)
    prefixes = {k.split(".")[0] for k in saved["state_dict"]}
    assert prefixes == ({"superpoint", "model"} if weight == "gim_lightglue"
                        else {"model"})
    cfg = small_head_config(weight, 64)
    m = Matcher.from_checkpoint(weight, ckpt, cfg, device="cpu")
    trained = TR.Trainer(cfg, 1, 1, 1, torch.device("cpu"), weight=weight)
    trained.load(os.path.join(ckpt, "step_00000003.ckpt"))
    for k, v in trained.model.state_dict().items():
        assert torch.equal(v, m.model.state_dict()[k]), k
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    r = m.match(x, torch.roll(x, 3, -1))
    assert torch.isfinite(r.kpts0).all() and torch.isfinite(r.kpts1).all()


def _tiny_batch(seed=0, nan=False):
    rng = np.random.default_rng(seed)
    c0 = rng.random((1, 3, 64, 64)).astype(np.float32)
    if nan:
        c0[0, 0, :8] = np.nan
    p0 = rng.uniform(0, 56, (1, 64, 2))
    lab = np.concatenate([p0, p0 + 3.0], -1).astype(np.float32)
    return {"color0": torch.from_numpy(c0),
            "color1": torch.from_numpy(np.roll(c0, 3, axis=(2, 3))),
            "labels": torch.from_numpy(lab),
            "label_valid": torch.ones(1, 64, dtype=torch.bool)}


def test_train_loop_nonfinite_guard_reverts_the_step():
    """With "skip" a non-finite step is undone (parameters, BatchNorm
    statistics, optimizer and scheduler) and its batch skipped; with
    "abort" the loop stops."""
    cfg = GimConfig(loftr=LoFTRConfig(max_matches=16, layer_names_c=1))

    def trainer():
        return TR.Trainer(cfg, 1, 1, 10, torch.device("cpu"))

    good, bad = _tiny_batch(), _tiny_batch(nan=True)
    tr, ref = trainer(), trainer()
    notes = []
    out = TR.train_loop(tr, iter([bad, good]), 1, on_nonfinite="skip",
                        log=notes.append)
    TR.train_loop(ref, iter([good]), 1)
    assert len(out) == 1 and np.isfinite(out[0]["loss"])
    assert "NON-FINITE" in notes[0] and tr.step_count == 1
    for k, v in ref.model.state_dict().items():
        assert torch.equal(v, tr.model.state_dict()[k]), k
    assert ref.scheduler.state_dict() == tr.scheduler.state_dict()
    with pytest.raises(SystemExit, match="NON-FINITE"):
        TR.train_loop(trainer(), iter([bad]), 1)
