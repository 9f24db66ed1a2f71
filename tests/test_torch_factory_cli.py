"""The factory's CLIs against the JAX CLIs on the CPU, on a cv2-written
synthetic video: `video_preprocessor.process_video` (the no-resize round
and the zoom-in round), `propagate` and `demo`, with root_sift (cv2 SIFT
on the host, no weights) and the RANSAC draws fixed in both packages:
the port's `geometry.ransac.ransac` takes, for each generator it is
given, the uniforms JAX draws from `PRNGKey(seed)` with that seed.

Tolerances: the same pairs, raw match counts and headers; the labels'
rows agree on >= 99 % (float32 rows rounded to 1e-3 px), as
tests/test_torch_geometry.py holds RANSAC's inliers (its IRLS refits
round differently in the two packages). `walk_viz` and `process_videos`
run on the port's outputs (the JAX scheduler swallows a task's failure;
the port's logs it, runs the rest and exits 1 naming it, so their stores
are compared through process_video).
"""

import os
import shutil
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from gim_tpu_torch.geometry import ransac as tr
from tests.test_torch_geometry import jax_noise
from tests.test_walk_and_factory import _write_synth_video


@pytest.fixture
def jax_draws(monkeypatch):
    real = tr.ransac

    def fixed(p0, p1, valid, thr, *, num_hypotheses=1024, noise=None,
              generators=None, **kw):
        if noise is None:
            banks = [jax_noise(jax.random.PRNGKey(g.initial_seed()),
                               num_hypotheses, p0.shape[1])
                     for g in generators]
            noise = tuple(torch.tensor(np.stack(b)).to(p0.device)
                          for b in zip(*banks))
        return real(p0, p1, valid, thr, num_hypotheses=num_hypotheses,
                    noise=noise, **kw)

    monkeypatch.setattr(tr, "ransac", fixed)


def _overlap(a, b):
    """The share of a's rows (rounded to 1e-3, counted with repeats) that
    b holds too."""
    ca = Counter(tuple(r) for r in np.round(a, 3))
    cb = Counter(tuple(r) for r in np.round(b, 3))
    return sum((ca & cb).values()) / max(len(a), 1)


def _assert_stores_agree(jstore, tstore):
    assert sorted(jstore._index) == sorted(tstore._index)
    for i, j, n in jstore._index:
        a, b = jstore.load(i, j), tstore.load(i, j)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if n:
            same = _overlap(a, b)
            assert same >= 0.99, (i, j, same)


def test_process_video_both_rounds_match_jax(tmp_path, jax_draws):
    from gim_tpu.cli import video_preprocessor as jv
    from gim_tpu_torch.cli import video_preprocessor as tv

    video = str(tmp_path / "vid.mp4")
    _write_synth_video(video)
    kw = dict(skip=8, max_pairs=3, min_matches=8)
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    js = jv.process_video(video, roots["jax"], "root_sift", **kw)
    ts = tv.process_video(video, roots["port"], "root_sift", device="cpu",
                          **kw)
    _assert_stores_agree(js, ts)
    assert sum(1 for *_, n in ts._index if n > 0) >= 2
    for r in roots.values():       # the rT round crops around this cache
        shutil.copytree(os.path.join(r, "vid", tv.store_name(
            "root_sift", 8, False)), os.path.join(r, "vid", tv.store_name(
                "gim_dkm", 8, False)))
    js = jv.process_video(video, roots["jax"], "root_sift", resize=True,
                          **kw)
    ts = tv.process_video(video, roots["port"], "root_sift", resize=True,
                          device="cpu", **kw)
    _assert_stores_agree(js, ts)
    labs = [ts.load(i, j) for i, j, n in ts._index if n > 0]
    assert labs
    for lab in labs:           # in the video's pixels
        assert (lab[:, [0, 2]] <= 128).all() and (lab[:, [1, 3]] <= 96).all()
        assert (lab >= 0).all()
    # resumable: a second run adds nothing
    again = tv.process_video(video, roots["port"], "root_sift", resize=True,
                             device="cpu", **kw)
    assert sorted(again._index) == sorted(ts._index)


def test_label_pair_masks_and_maps_back(monkeypatch):
    """The per-pair body alone: a mask over a whole frame skips the pair,
    too few matches give an empty label set, and labels are mapped
    through the crop and vratio."""
    from gim_tpu_torch.cli import video_preprocessor as tv
    from gim_tpu_torch.data import walk

    rgb = np.full((16, 16, 3), 200, np.uint8)
    k = np.random.default_rng(0).uniform(0, 16, (20, 2)).astype(np.float32)

    def match(a, b):
        return k, k + 3, np.ones(len(k), np.float32)

    monkeypatch.setattr(walk, "onchip_fundamental_filter",
                        lambda k0, k1, thr, device: np.ones(len(k0), bool))
    vr = np.array([[2.0, 0.5]], np.float32)
    assert tv.label_pair(rgb, rgb, match, vr,
                         segment=lambda x: np.ones(x.shape[:2], bool),
                         device="cpu") is None
    lab, n = tv.label_pair(rgb, rgb, match, vr, min_matches=64,
                           device="cpu")
    assert lab.shape == (0, 4) and n == 20
    crop = (np.array([[0.5, 0.5]], np.float32),
            np.array([[4.0, 2.0]], np.float32))
    lab, n = tv.label_pair(rgb, rgb, match, vr, crop0=crop, crop1=crop,
                           min_matches=8, device="cpu")
    np.testing.assert_allclose(lab[:, :2], (k * 0.5 + [4, 2]) * vr[0])
    np.testing.assert_allclose(lab[:, 2:], ((k + 3) * 0.5 + [4, 2]) * vr[0])


def test_propagate_cli_matches_jax_and_walk_viz_draws(tmp_path, jax_draws,
                                                      capsys):
    import cv2

    from gim_tpu.cli import propagate as jp
    from gim_tpu_torch.cli import propagate as tp
    from gim_tpu_torch.cli import walk_viz
    from gim_tpu_torch.data.synthetic import write_planted_label_stores

    video = str(tmp_path / "seq.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (320, 240))
    for i in range(130):
        vw.write(np.full((240, 320, 3), i, np.uint8))
    vw.release()
    for name in ("jax", "port"):
        write_planted_label_stores(str(tmp_path / name / "seq"),
                                   width=320, height=240, n_tracks=800,
                                   drop=((10, 50, 60),))
    jp.main(["--video", video, "--labels_root", str(tmp_path / "jax"),
             "--step", "30"])
    tp.main(["--video", video, "--labels_root", str(tmp_path / "port"),
             "--step", "30", "--device", "cpu"])
    out = capsys.readouterr().out
    jdir = tmp_path / "jax" / "seq" / "propagate"
    tdir = tmp_path / "port" / "seq" / "propagate"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert "4/4 pairs propagated" in out or "3/4 pairs propagated" in out
    n_files = 0
    for n in names:
        if not n.endswith(".npy"):
            assert (jdir / n).read_bytes() == (tdir / n).read_bytes()
            continue
        a, b = np.load(jdir / n), np.load(tdir / n)
        assert np.array_equal(a[0], b[0])               # the header row
        same = _overlap(a[1:], b[1:])
        assert same >= 0.99 and abs(len(a) - len(b)) <= 0.01 * len(a)
        n_files += 1
    assert n_files >= 3
    walk_viz.main(["--video", video, "--labels_root", str(tmp_path / "port"),
                   "--out_dir", str(tmp_path / "viz"), "--num", "2"])
    figs = sorted((tmp_path / "viz").iterdir())
    assert len(figs) == 2 and cv2.imread(str(figs[0])).shape[1] == 648


def test_process_videos_runs_the_task_matrix(tmp_path, monkeypatch):
    from gim_tpu.cli import process_videos as jpv
    from gim_tpu_torch.cli import process_videos as tpv
    from gim_tpu_torch.cli import video_preprocessor as tv

    vdir = tmp_path / "videos"
    vdir.mkdir()
    _write_synth_video(str(vdir / "a.mp4"))
    calls = []
    monkeypatch.setattr(tv, "process_video",
                        lambda *a, **k: calls.append((a, k)))
    tpv.main(["--video_dir", str(vdir), "--labels_root", str(tmp_path / "l"),
              "--methods", "root_sift", "gim_dkm", "--device", "cpu"])
    tasks = [(a[2], a[3], k["resize"]) for a, k in calls]
    assert tasks == tpv.tasks_for(30.0, ["root_sift", "gim_dkm"])
    assert len(tasks) == 12 and all(not r for *_, r in tasks[:6])
    assert (tpv.LOW_FPS_SKIPS, tpv.HIGH_FPS_SKIPS) == (jpv.LOW_FPS_SKIPS,
                                                      jpv.HIGH_FPS_SKIPS)
    assert {k["device"] for _, k in calls} == {"cpu"}


def test_process_videos_runs_the_rest_after_a_failed_task(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """One task raises: the others' stores are written, the failure is
    logged, and the run exits 1 naming the failed task."""
    from gim_tpu_torch.cli import process_videos as tpv
    from gim_tpu_torch.cli import video_preprocessor as tv

    vdir = tmp_path / "videos"
    vdir.mkdir()
    _write_synth_video(str(vdir / "a.mp4"))
    out = tmp_path / "labels"

    def fake(path, labels_root, method, skip, *a, resize=False, **k):
        if (method, skip, resize) == ("gim_dkm", 20, False):
            raise RuntimeError("planted failure")
        store = os.path.join(labels_root, f"{method}_{skip}_{resize}.npy")
        os.makedirs(labels_root, exist_ok=True)
        np.save(store, np.zeros((1, 4), np.float32))

    monkeypatch.setattr(tv, "process_video", fake)
    with pytest.raises(SystemExit) as e:
        tpv.main(["--video_dir", str(vdir), "--labels_root", str(out),
                  "--methods", "root_sift", "gim_dkm", "--device", "cpu"])
    assert "1 task(s) failed: (a.mp4,gim_dkm,20,rFalse)" in str(e.value.code)
    log = capsys.readouterr()
    assert "planted failure" in log.out + log.err
    written = sorted(os.listdir(out))
    assert len(written) == 11 and "gim_dkm_20_False.npy" not in written
    assert "gim_dkm_40_True.npy" in written     # tasks after the failure


def test_demo_cli_matches_jax(tmp_path, jax_draws, capsys):
    import cv2

    from gim_tpu.cli import demo as jd
    from gim_tpu.data.synthetic import make_pair
    from gim_tpu_torch.cli import demo as td

    rng = np.random.default_rng(11)
    img0, img1, _, _ = make_pair(rng, H=240, W=320)
    p0, p1 = str(tmp_path / "x1.png"), str(tmp_path / "x2.png")
    cv2.imwrite(p0, img0[..., ::-1])
    cv2.imwrite(p1, img1[..., ::-1])
    args = ["--model", "root_sift", "--img0", p0, "--img1", p1,
            "--img_size", "256"]
    jd.main(args + ["--out_dir", str(tmp_path)])
    jout = capsys.readouterr().out
    (tmp_path / "port").mkdir()
    got = td.main(args + ["--out_dir", str(tmp_path / "port"), "--device",
                          "cpu"])
    tout = capsys.readouterr().out

    def count(out, what):
        line = next(x for x in out.splitlines() if what in x)
        return int(line.split()[1])

    assert count(tout, "raw matches") == count(jout, "raw matches")
    n_in = count(jout, "inliers after")
    assert abs(count(tout, "inliers after") - n_in) <= 0.01 * n_in
    assert int(got["inliers"].sum()) == count(tout, "inliers after")
    for suffix in ("match", "warp", "rect"):
        assert (tmp_path / "port" / f"x1_x2_root_sift_{suffix}.png").exists()
