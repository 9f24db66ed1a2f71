"""The propagation half of the port's WALK data against the JAX package,
on the CPU: the chain linker (compiled, numpy, JAX), the propagator's
files on planted stores (byte-equal), and the fundamental-matrix filter
given JAX's uniforms.

Tolerances: `link` returns the same set of chains in all three; the
propagated files and the ledger of bad pairs are byte-equal; the filter's
keep mask agrees with JAX's `ransac` on >= 99 % of labels, as
tests/test_torch_geometry.py holds `ransac` itself (its IRLS refits
round differently in the two packages).
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gim_tpu.data import walk as JW
from gim_tpu.native import _link_numpy as j_link_numpy
from gim_tpu_torch import native
from gim_tpu_torch.data import walk as TW
from gim_tpu_torch.data.synthetic import write_planted_label_stores
from tests.test_torch_geometry import jax_noise, make_scene


def _labels(rng, n, w=640, h=480):
    a = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    b = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    return np.concatenate([a, b], axis=1)


def _rows(a):
    return {tuple(np.round(r, 3)) for r in a}


def test_link_compiled_numpy_and_jax_give_the_same_chains():
    rng = np.random.default_rng(0)
    l0 = _labels(rng, 300)
    l1 = _labels(rng, 280)
    l1[:120, :2] = l0[:120, 2:]
    l1[120:130, :2] = l0[7, 2:]          # many rows on one middle pixel
    before = native.CALLS["compiled"]
    got = native.link_fast(l0, l1, 640)
    assert native.CALLS["compiled"] == before + 1
    assert _rows(got) == _rows(native.link_numpy(l0, l1, 640))
    assert _rows(got) == _rows(JW.link(l0, l1, 640, 0))
    assert _rows(got) == _rows(j_link_numpy(l0, l1, 640))
    assert len(got) >= 120
    for a, b in (((0, 4), (0, 4)), ((5, 4), (0, 4))):     # empty inputs
        e = native.link_fast(np.zeros(a, np.float32),
                             np.zeros(b, np.float32), 640)
        assert e.shape == (0, 4)


def test_link_threshold_and_create_table():
    rng = np.random.default_rng(1)
    l0 = _labels(rng, 50)
    l1 = _labels(rng, 50)
    l1[:5, :2] = l0[:5, 2:]
    assert TW.link(l0, l1, 640, min_final_matches=64) is None
    assert _rows(TW.link(l0, l1, 640, 4)) == _rows(JW.link(l0, l1, 640, 4))
    x, y = l0[:, 0], l0[:, 1]
    assert TW.create_table(x, y, 640) == JW.create_table(x, y, 640)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "link.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", [])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.link_fast(np.zeros((1, 4), np.float32),
                         np.zeros((1, 4), np.float32), 640)


def _keep_near(k0, k1, thr):
    """A deterministic stand-in for the robust filter, the same in both
    packages: labels that moved less than 400 px."""
    return np.abs(k0 - k1).max(1) < 400 * thr


@pytest.mark.parametrize("with_filter", [False, True])
def test_propagator_files_are_byte_equal_to_jax(tmp_path, with_filter):
    seq = tmp_path / "seq"
    stores = write_planted_label_stores(
        str(seq), n_frames=130, width=640, height=360, n_tracks=600,
        drop=((10, 50, 60), (20, 40, 60), (10, 100, 110)))
    jsrc = {s: [JW.LabelStore(st.root)] for s, st in stores.items()}
    tsrc = {s: [st] for s, st in stores.items()}
    jcfg, tcfg = JW.PropagationConfig(), TW.PropagationConfig()
    assert vars(jcfg) == vars(tcfg)
    jp = JW.Propagator(jsrc, 640, jcfg, str(tmp_path / "jax"))
    tp = TW.Propagator(tsrc, 640, tcfg, str(tmp_path / "port"))
    filt = _keep_near if with_filter else None
    pairs = [(0, 100), (10, 110), (20, 120), (0, 60), (0, 30), (0, 40),
             (40, 80), (0, 10)]
    for i0, i1 in pairs:
        a = jp.propagate_pair(i0, i1, ransac_filter=filt)
        b = tp.propagate_pair(i0, i1, ransac_filter=filt)
        assert (a is None) == (b is None), (i0, i1)
        if a is not None:
            assert a[1:] == b[1:] and np.array_equal(a[0], b[0])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "bad_pairs.txt" in names and len(names) >= 4
    for n in names:
        assert ((tmp_path / "jax" / n).read_bytes()
                == (tmp_path / "port" / n).read_bytes()), n
    # a second call reads the stored file back
    again = tp.propagate_pair(0, 100, ransac_filter=filt)
    first = np.load(tmp_path / "port" / "0_100.npy")
    assert again[1:] == tuple(first[0, :2].astype(int))
    shutil.rmtree(seq)


@pytest.mark.parametrize("n", [300, 700])
def test_fundamental_filter_matches_jax_given_its_uniforms(n):
    rng = np.random.default_rng(n)
    p0, p1, _, _, _ = make_scene(rng, n, n, 0.7, 0.1)   # its scenes
    M = 1 << int(np.ceil(np.log2(n)))
    k1, k2 = jax_noise(jax.random.PRNGKey(n), 1024, M)
    want = JW.onchip_fundamental_filter(p0, p1, 1.0)
    got = TW.onchip_fundamental_filter(
        p0, p1, 1.0, device="cpu",
        noise=(torch.tensor(k1[None]), torch.tensor(k2[None])))
    assert got.shape == want.shape == (n,) and got.dtype == bool
    assert (got == want).mean() >= 0.99, (got == want).mean()
    assert want.sum() >= 0.6 * n
    # the generator path: its own uniforms, the same inliers in two calls
    a = TW.onchip_fundamental_filter(p0, p1, 1.0, device="cpu")
    b = TW.onchip_fundamental_filter(p0, p1, 1.0, device="cpu")
    assert np.array_equal(a, b) and a.sum() >= 0.6 * n


def test_fundamental_filter_few_labels_and_no_cuda(monkeypatch):
    k = np.zeros((5, 2), np.float32)
    assert not TW.onchip_fundamental_filter(k, k, 1.0, device="cpu").any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TW.onchip_fundamental_filter(k, k, 1.0)


def test_planted_stores_are_found_by_the_propagate_cli(tmp_path):
    from gim_tpu.cli.propagate import discover_sources as j_discover
    from gim_tpu_torch.cli.propagate import discover_sources

    write_planted_label_stores(str(tmp_path), n_frames=50, n_tracks=40)
    got = {s: [Path(x.root).name for x in v]
           for s, v in discover_sources(str(tmp_path)).items()}
    want = {s: [Path(x.root).name for x in v]
            for s, v in j_discover(str(tmp_path)).items()}
    assert got == want == {10: ["planted_s10_rF"], 20: ["planted_s20_rF"],
                           40: ["planted_s40_rF"]}
