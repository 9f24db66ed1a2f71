"""ZEB evaluation in gim_tpu_torch against gim_tpu on the CPU: loaders,
image ops, dump files, root_sift, the CLIs, and the whole slice with
gim_loftr.

Tolerances:
- loaders, the synthetic benchmark writer, dump text: identical (records,
  arrays, bytes);
- `ops/image.preprocess_image`: within 1e-4 (images in [0, 1]);
- `match_rootsift`: identical indices, confidences within 1e-6;
- the root_sift CLI on 6 synthetic pairs: auc@5 within 0.1 of the JAX
  CLI's (their RANSAC streams differ: threefry against torch's);
- `match_pair_rootsift` and the numpy aggregates: identical;
- the slice (gim_loftr at test_torch_loftr's weights, two synthetic pairs
  at 192 px whose image 1 is image 0 with its halves moved 8 and 24 px,
  JAX's RANSAC uniforms): the same identifiers and valid slots (>= 24
  each), keypoints within 1e-3 px and confidences within rtol 1e-4
  (test_torch_loftr's), epipolar errors within rtol 1e-3 + atol 1e-7
  (1e-3 px of keypoint difference at a focal of 156 px moves a residual
  by ~1e-5), the same success flags, inlier masks equal on >= 90 %, R and
  t errors within 0.05 deg where JAX's are below 5 deg.
"""

import ast
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gim_tpu.api import match_fn as j_match_fn
from gim_tpu.cli import zeb_eval as j_cli
from gim_tpu.config import GimConfig as JGimConfig
from gim_tpu.config import LoFTRConfig as JLoFTRConfig
from gim_tpu.data import synthetic as j_syn
from gim_tpu.data import zeb as JZ
from gim_tpu.eval import zeb as JE
from gim_tpu.models import root_sift as j_rs
from gim_tpu.ops import image as j_img
from gim_tpu_torch import api
from gim_tpu_torch.api import MatchResult, match_fn
from gim_tpu_torch.cli import analysis as t_analysis
from gim_tpu_torch.cli import check as t_check
from gim_tpu_torch.cli import zeb_eval as t_cli
from gim_tpu_torch.config import GimConfig, LoFTRConfig
from gim_tpu_torch.data import synthetic as t_syn
from gim_tpu_torch.data import zeb as TZ
from gim_tpu_torch.eval import zeb as TE
from gim_tpu_torch.models import root_sift as t_rs
from gim_tpu_torch.ops import image as t_img
from gim_tpu_torch.weights.port import loftr_state_dict_from_jax
from tests.test_torch_fence import ROOT, _imported_roots, _port_files
from tests.test_torch_loftr import _port_model, make_variables
from tests.test_zeb_data import CASES, _write_layout

HIGH = jax.default_matmul_precision("highest")


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """Six synthetic pairs written by the JAX package's writer."""
    root = str(tmp_path_factory.mktemp("synth"))
    j_syn.write_synthetic_benchmark(root, n_pairs=6)
    return root


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_synthetic_benchmark_is_byte_identical(synth_root, tmp_path):
    t_syn.write_synthetic_benchmark(str(tmp_path), n_pairs=6)
    want, got = _files(synth_root), _files(str(tmp_path))
    assert len(want) == 18 and sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def _same_pairs(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in ("identifier", "img_path0", "img_path1", "covisible0",
                  "covisible1"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("K0", "K1", "T_0to1"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("key,n0,n1,img0,ident", CASES,
                         ids=[c[0] for c in CASES])
def test_load_benchmark_layouts(tmp_path, key, n0, n1, img0, ident):
    """All 12 reference layouts resolve to the same records."""
    _write_layout(str(tmp_path), key, n0, n1, img0, img0.replace("12", "34"))
    got = TZ.load_benchmark(str(tmp_path), key)
    _same_pairs(got, JZ.load_benchmark(str(tmp_path), key))
    assert got[0].identifier == ident


def test_load_and_preprocess_synthetic(synth_root):
    got = TZ.load_benchmark(synth_root, "GL3D", max_samples=4)
    want = JZ.load_benchmark(synth_root, "GL3D", max_samples=4)
    _same_pairs(got, want)
    for padding in (True, False):
        g = TZ.load_pair_images(got[1], 320, 8, padding)
        w = JZ.load_pair_images(want[1], 320, 8, padding)
        assert sorted(g) == sorted(w)
        for k in g:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
        gb = TZ.batch_pairs([g, g])
        wb = JZ.batch_pairs([w, w])
        assert sorted(gb) == sorted(wb)
        for k in gb:
            np.testing.assert_array_equal(np.asarray(gb[k]),
                                          np.asarray(wb[k]), err_msg=k)


@pytest.mark.parametrize("hw,max_resize,padding", [
    ((120, 90), 64, True), ((37, 53), 48, False), ((50, 70), 100, True)])
def test_preprocess_image(hw, max_resize, padding):
    rng = np.random.default_rng(hw[0])
    rgb = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = j_img.preprocess_image(rgb, max_resize, 8, padding)
    got = t_img.preprocess_image(rgb, max_resize, 8, padding, device="cpu")
    assert got.resize_hw == want.resize_hw
    for k in ("gray", "color", "scale"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-4, err_msg=k)
    if padding:
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    else:
        assert got.mask is None and want.mask is None


def test_image_ops_pad_and_normalize():
    rng = np.random.default_rng(1)
    img = rng.random((2, 3, 10, 14)).astype(np.float32)
    spec = t_img.aspect_pad_spec(10, 14, 32, 24)
    assert vars(spec) == vars(j_img.aspect_pad_spec(10, 14, 32, 24))
    assert spec.padded_wh == j_img.aspect_pad_spec(10, 14, 32, 24).padded_wh
    np.testing.assert_array_equal(
        t_img.aspect_pad(torch.from_numpy(img), spec).numpy(),
        np.asarray(j_img.aspect_pad(jnp.asarray(img), spec)))
    kp = rng.uniform(-5, 30, (7, 2)).astype(np.float32)
    g = t_img.aspect_unpad_mask(torch.from_numpy(kp), spec)
    w = j_img.aspect_unpad_mask(jnp.asarray(kp), spec)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]))
    np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    np.testing.assert_allclose(
        t_img.normalize_imagenet(torch.from_numpy(img)).numpy(),
        np.asarray(j_img.normalize_imagenet(jnp.asarray(img))), rtol=1e-6)
    hwc = img[0].transpose(1, 2, 0)
    for ret_mask in (False, True):
        g = t_img.pad_bottom_right(torch.from_numpy(hwc), 16, ret_mask)
        w = j_img.pad_bottom_right(jnp.asarray(hwc), 16, ret_mask)
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        if ret_mask:
            np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))


def _rows():
    rng = np.random.default_rng(2)
    rows = []
    for i, n in enumerate((5, 0, 9)):
        rows.append({
            "identifier": f"scene#{i:02d}#{i + 1:02d}",
            "covisible0": 0.5, "covisible1": 0.25 * i,
            "epi_errs": (10.0 ** rng.uniform(-6, -2, n)).astype(np.float32),
            "inliers": rng.random(n) > 0.3,
            "R_errs": float(np.float32(rng.uniform(0, 3))),
            "t_errs": float("inf") if i == 1 else float(np.float32(0.7)),
            "t_errs2": float(np.float32(rng.uniform(0, 1))),
        })
    return rows + rows[:1]                       # a duplicate, deduped


def test_dump_text_is_byte_identical(tmp_path):
    rows = _rows()
    assert TE.format_rows(rows) == JE.format_rows(rows)
    assert TE.dedup_rows(rows) == JE.dedup_rows(rows)
    a = TE.write_dump(rows, str(tmp_path / "t"), "w", "GL3D", "v0")
    b = JE.write_dump(rows, str(tmp_path / "j"), "w", "GL3D", "v0")
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert TE.identifier_key("a#b#c").tolist() == \
        JE.identifier_key("a#b#c").tolist()
    assert TE.RANSAC_ZOO == JE.RANSAC_ZOO
    assert TE.gather_rows_multihost(rows) is rows
    TE.barrier_multihost("test")


def test_match_rootsift_identical_indices():
    rng = np.random.default_rng(3)
    n0, n1 = 512, 480

    def rootsift(n):
        d = rng.random((n, 128)).astype(np.float32) ** 4
        return np.sqrt(d / d.sum(1, keepdims=True))

    d1 = rootsift(n1)
    d0 = rootsift(n0)
    # half of image 0's descriptors are noisy copies of image 1's
    src = rng.permutation(n1)[:n0 // 2]
    d0[:n0 // 2] = d1[src] + 0.01 * rng.random((n0 // 2, 128))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    k0 = rng.uniform(0, 640, (n0, 2)).astype(np.float32)
    k1 = rng.uniform(0, 640, (n1, 2)).astype(np.float32)
    v0 = rng.random(n0) > 0.1
    v1 = rng.random(n1) > 0.1
    d0, d1 = d0.astype(np.float32), d1.astype(np.float32)
    wm, wc = j_rs.match_rootsift(*(jnp.asarray(a) for a in (k0, d0, v0, k1,
                                                           d1, v1)))
    gm, gc = t_rs.match_rootsift(*(torch.from_numpy(a) for a in (k0, d0, v0,
                                                                k1, d1, v1)))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-6)
    assert (gm.numpy() >= 0).sum() > n0 // 4


def test_match_pair_rootsift_and_aggregates(synth_root):
    """The whole host + device RootSIFT pipeline on one synthetic pair, and
    the numpy aggregation of pose errors, against the JAX package's."""
    import cv2

    from gim_tpu.geometry import pose as j_pose
    from gim_tpu_torch.geometry import pose as t_pose

    p = JZ.load_benchmark(synth_root, "GL3D", max_samples=1)[0]
    rgb = [cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB)
           for f in (p.img_path0, p.img_path1)]
    got = t_rs.match_pair_rootsift(*rgb, max_kpts=2048, device="cpu")
    want = j_rs.match_pair_rootsift(*rgb, max_kpts=2048)
    assert len(got[0]) > 100
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)

    rows = _rows()
    metrics = {"identifiers": [r["identifier"] for r in rows],
               "R_errs": [r["R_errs"] for r in rows],
               "t_errs": [r["t_errs"] for r in rows],
               "epi_errs": [r["epi_errs"] for r in rows]}
    assert t_pose.aggregate_metrics(metrics, test=True) == \
        j_pose.aggregate_metrics(metrics, test=True)
    assert t_pose.error_auc_trapezoid(metrics["R_errs"], metrics["t_errs"],
                                      (5.0, 10.0)) == \
        j_pose.error_auc_trapezoid(metrics["R_errs"], metrics["t_errs"],
                                   (5.0, 10.0))


def test_cli_root_sift_dump_analysis_check(tmp_path, monkeypatch, capsys):
    """The port's CLI on 6 synthetic pairs: a reference-format dump that
    the port's analysis and check read; auc@5 within 0.1 of the JAX
    CLI's on the same pairs."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    common = ["--synthetic", "--weight", "root_sift", "--synthetic_pairs",
              "6", "--img_size", "320", "--ransac", "FAST"]
    got = t_cli.main(common + ["--device", "cpu",
                               "--out_dir", str(tmp_path / "t")])
    path = TE.dump_path(str(tmp_path / "t"), "root_sift", "GL3D", "v0")
    assert os.path.exists(path)
    det = t_analysis.read_dump(path)
    assert len(det["R_errs"]) == 6 and len(det["Aft.Num"]) == 6
    res = t_analysis.main(["--dir", str(tmp_path / "t"), "--wid",
                           "root_sift"])
    assert res["GL3D"] == pytest.approx(got["auc@5.0"])
    want = j_cli.main(common + ["--out_dir", str(tmp_path / "t"),
                                "--version", "jax"])
    assert abs(got["auc@5.0"] - want["auc@5.0"]) <= 0.1, (got, want)
    t_check.main(["--dir", str(tmp_path / "t")])     # same identifiers
    out = capsys.readouterr().out
    assert "auc@5" in out and "Good" in out


def test_cli_raises_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["--synthetic", "--weight", "root_sift"])
    with pytest.raises(NotImplementedError, match="slice 5"):
        t_cli.main(["--weight", "gim_lightglue", "--device", "cpu"])


def test_chip_smoke_imports_no_cv2():
    """The card's machine has no OpenCV: cv2 stays a host dependency of
    the data loaders and root_sift's detector, imported inside them."""
    assert "cv2" not in set(_imported_roots(ROOT / "chip_smoke.py"))
    top = {n.names[0].name.split(".")[0]
           for f in _port_files()
           for n in ast.parse(f.read_text()).body
           if isinstance(n, ast.Import)}
    assert "cv2" not in top


def test_root_sift_matches_through_the_api():
    """root_sift through Matcher / match_fn: host SIFT, device match, one
    slot per keypoint of image 0, keypoints in the original frame."""
    rng = np.random.default_rng(0)
    img = np.zeros((1, 3, 96, 128), np.float32)
    for _ in range(40):
        y, x = rng.integers(8, 88), rng.integers(8, 120)
        img[0, :, y - 4:y + 4, x - 4:x + 4] = rng.random((3, 1, 1))
    a = torch.from_numpy(img)
    b = torch.roll(a, (3, 5), dims=(2, 3))
    m = api.Matcher("root_sift", device="cpu")
    assert m.model is None
    r = m.match(a, b, torch.tensor([[2.0, 2.0]]), torch.tensor([[2.0, 2.0]]))
    assert r.kpts0.shape == (1, 6144, 2) and r.valid.shape == (1, 6144)
    v = r.valid[0]
    assert int(v.sum()) >= 10
    d = (r.kpts1[0][v] - r.kpts0[0][v]) / 2.0
    assert float((d - torch.tensor([5.0, 3.0])).abs().max()) < 1.0
    with pytest.raises(NotImplementedError, match="checkpoint"):
        api.Matcher.from_checkpoint("root_sift", "missing.ckpt",
                                    device="cpu")


# ---------------------------------------------------------------------------
# the slice: gim_loftr -> evaluate -> rows
# ---------------------------------------------------------------------------

H_HYP, MAXM, SIZE = 64, 256, 192


def _jax_uniforms(ids, m):
    """RANSAC's banks as the JAX package draws them per pair from the
    identifier key (gim_tpu/eval/zeb.py:122-123, ransac.py:175, :323)."""
    first, lo = [], []
    for i in ids:
        k1, k2 = jax.random.split(jnp.asarray(JE.identifier_key(i)))
        first.append(np.asarray(jax.random.uniform(k1, (H_HYP, m))))
        lo.append(np.asarray(jax.random.uniform(k2, (32, m))))
    return torch.from_numpy(np.stack(first)), torch.from_numpy(np.stack(lo))


def _shifted_sample(pair):
    """A ZEB sample whose image 1 is image 0 with its left half moved 8 px
    and its right half 24 px (two fronto-parallel planes under a sideways
    camera move): random weights match an image with a shifted copy of
    itself, and not two views of the synthetic scene."""
    s = JZ.load_pair_images(pair, SIZE, 8, True)
    c0 = s["color0"]
    c1 = np.zeros_like(c0)
    h = c0.shape[-1] // 2
    c1[..., 8:h] = c0[..., :h - 8]
    c1[..., h + 24:] = c0[..., h:-24]
    s["color1"] = c1 * s["mask0"][None]
    s["mask1"] = s["mask0"]
    s["K1"] = s["K0"]
    s["T_0to1"] = np.eye(4, dtype=np.float32)
    s["T_0to1"][0, 3] = -1.0
    return s


def test_slice_gim_loftr_evaluate_matches_jax(synth_root):
    """gim_loftr -> evaluate -> rows on two pairs, the port against the
    JAX package with the same weights and RANSAC uniforms."""
    variables = make_variables()
    kw = dict(max_matches=MAXM, match_threshold=0.0)
    # pairs 0 and 2: 27 and 29 valid matches (pair 1 has 4)
    samples = [_shifted_sample(p) for p in
               JZ.load_benchmark(synth_root, "GL3D")[0:3:2]]

    jcfg = JGimConfig(loftr=JLoFTRConfig(**kw))
    with HIGH:
        jfn = jax.jit(partial(j_match_fn, "gim_loftr", jcfg))
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)

        def j_match(batch):
            return jfn(jvars, *(jnp.asarray(batch[k]) for k in (
                "color0", "color1", "scale0", "scale1", "mask0", "mask1")))

        jmatches = []

        def j_record(batch):
            jmatches.append(j_match(batch))
            return jmatches[-1]

        want = JE.evaluate(j_record, (JZ.batch_pairs([s]) for s in samples),
                           num_hypotheses=H_HYP, progress=False)

    cfg = GimConfig(loftr=LoFTRConfig(**kw))
    model = _port_model(variables, cfg.loftr)
    assert model.state_dict().keys() == loftr_state_dict_from_jax(
        variables).keys()
    matches = []

    def t_match(batch):
        matches.append(match_fn(
            "gim_loftr", cfg, model, batch["color0"], batch["color1"],
            batch["scale0"], batch["scale1"], batch["mask0"],
            batch["mask1"], device="cpu"))
        return matches[-1]

    got = TE.evaluate(t_match, (TZ.batch_pairs([s]) for s in samples),
                      num_hypotheses=H_HYP, progress=False,
                      noise=lambda ids: _jax_uniforms(ids, MAXM))

    assert [r["identifier"] for r in got] == [r["identifier"] for r in want]
    for g, w, r, jr in zip(got, want, matches, jmatches):
        assert isinstance(r, MatchResult)
        np.testing.assert_array_equal(r.valid.numpy(), np.asarray(jr.valid))
        v = r.valid.numpy()
        assert v.sum() >= 24
        for k in ("kpts0", "kpts1"):
            np.testing.assert_allclose(getattr(r, k).numpy()[v],
                                       np.asarray(getattr(jr, k))[v],
                                       rtol=0, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(r.conf.numpy()[v], np.asarray(jr.conf)[v],
                                   rtol=1e-4)
        np.testing.assert_allclose(g["epi_errs"], w["epi_errs"], rtol=1e-3,
                                   atol=1e-7)
        assert np.isfinite(g["R_errs"]) == np.isfinite(w["R_errs"])
        for k in ("R_errs", "t_errs"):
            if w[k] < 5.0:
                assert abs(g[k] - w[k]) <= 0.05, (k, g[k], w[k])
        assert (g["inliers"] == w["inliers"]).mean() >= 0.9
