"""The port's bilinear-sampling backward (`ops.sampling.BilinearSample`)
against `F.grid_sample`'s own autograd in float64 and against the JAX
package's gathers (`jax.vjp` of `gim_tpu.ops.sampling.grid_sample`,
`sample_descriptors` and `gim_tpu.models.dkm.blocks.local_correlation`)
in float32, on the CPU.

Tolerances: float64 against torch's backward, 1e-12 of the largest
gradient magnitude (the two sum the same terms in another order); float32
against JAX, 2e-5 of the largest magnitude (float32 rounding of sums of
at most a few hundred terms). The cases cover zeros and border padding,
both `align_corners`, points outside the image and many points planted
on one pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gim_tpu.models.dkm import blocks as jb
from gim_tpu.ops import sampling as js
from gim_tpu_torch.models.dkm import blocks as tb
from gim_tpu_torch.ops import resize as tr
from gim_tpu_torch.ops import sampling as ts

HIGH = jax.default_matmul_precision("highest")
CASES = [(m, a) for m in ("zeros", "border") for a in (False, True)]


def _points(rng, N, P, planted: bool):
    """(N, P, 2) normalized xy reaching 30 % past each border; with
    `planted`, a third of the points on one pixel centre and a third on
    one pixel corner (exact integer source coordinates)."""
    g = rng.uniform(-1.3, 1.3, (N, P, 2))
    if planted:
        k = P // 3
        g[:, :k] = [0.25, -0.5]
        g[:, k:2 * k] = [0.0, 0.0]
    return g


def _assert_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("mode,align", CASES)
def test_backward_matches_torch_autograd_float64(mode, align, planted):
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((2, 5, 7, 9)))
    grid = torch.from_numpy(_points(rng, 2, 60, planted)).view(2, 6, 10, 2)
    w = torch.from_numpy(rng.standard_normal((2, 5, 6, 10)))
    grads = []
    for fn in (ts.bilinear_sample, F.grid_sample):
        a = img.clone().requires_grad_()
        b = grid.clone().requires_grad_()
        kw = {} if fn is ts.bilinear_sample else {"mode": "bilinear"}
        out = fn(a, b, padding_mode=mode, align_corners=align, **kw)
        (out * w).sum().backward()
        grads.append((out.detach(), a.grad, b.grad))
    (o1, gi1, gg1), (o2, gi2, gg2) = grads
    assert torch.equal(o1, o2)             # the forward is F.grid_sample
    _assert_close(gi1, gi2, 1e-12)
    _assert_close(gg1, gg2, 1e-12)


@pytest.mark.parametrize("mode,align", CASES)
def test_grid_sample_gradients_match_jax_vjp(mode, align):
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 6, 8, 11)).astype(np.float32)
    pts = _points(rng, 2, 90, True).astype(np.float32)
    w = rng.standard_normal((2, 6, 90)).astype(np.float32)
    out, vjp = jax.vjp(lambda i, g: js.grid_sample(
        i, g, align_corners=align, padding_mode=mode),
        jnp.asarray(img), jnp.asarray(pts))
    want_i, want_g = vjp(jnp.asarray(w))
    a = torch.from_numpy(img).requires_grad_()
    b = torch.from_numpy(pts).requires_grad_()
    got = ts.grid_sample(a, b, align_corners=align, padding_mode=mode)
    (got * torch.from_numpy(w)).sum().backward()
    _assert_close(got.detach(), out, 2e-5)
    _assert_close(a.grad, want_i, 2e-5)
    _assert_close(b.grad, want_g, 2e-5)


@pytest.mark.parametrize("legacy", [False, True])
def test_sample_descriptors_gradients_match_jax(legacy):
    rng = np.random.default_rng(3)
    desc = rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
    kpts = rng.uniform(-4, 68, (2, 40, 2)).astype(np.float32)
    w = rng.standard_normal((2, 40, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda d, k: js.sample_descriptors(k, d, 8, legacy),
                     jnp.asarray(desc), jnp.asarray(kpts))
    want_d, want_k = vjp(jnp.asarray(w))
    d = torch.from_numpy(desc).requires_grad_()
    k = torch.from_numpy(kpts).requires_grad_()
    (ts.sample_descriptors(k, d, 8, legacy)
     * torch.from_numpy(w)).sum().backward()
    _assert_close(d.grad, want_d, 2e-5)
    _assert_close(k.grad, want_k, 2e-5)


@pytest.mark.parametrize("radius,with_flow", [(2, True), (3, False)])
def test_local_correlation_gradients_match_jax(radius, with_flow):
    """x, y and flow gradients of the local correlation against `jax.vjp`
    of the JAX package's default (packed-row) form; the flow reaches past
    the border."""
    rng = np.random.default_rng(radius)
    x = rng.standard_normal((2, 9, 10, 8)).astype(np.float32)
    y = rng.standard_normal((2, 9, 10, 8)).astype(np.float32)
    flow = rng.uniform(-1.1, 1.1, (2, 9, 10, 2)).astype(np.float32)
    K2 = (2 * radius + 1) ** 2
    w = rng.standard_normal((2, 9, 10, K2)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(y)) + (
        (jnp.asarray(flow),) if with_flow else ())
    with HIGH:
        _, vjp = jax.vjp(lambda a, b, *f: jb.local_correlation(
            a, b, radius, flow=f[0] if f else None), *args)
        want = vjp(jnp.asarray(w))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    ty = torch.from_numpy(y).permute(0, 3, 1, 2).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_() if with_flow else None
    got = tb.local_correlation(tx, ty, radius, tf)
    (got * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    _assert_close(tx.grad.permute(0, 2, 3, 1), want[0], 2e-5)
    _assert_close(ty.grad.permute(0, 2, 3, 1), want[1], 2e-5)
    if with_flow:
        _assert_close(tf.grad, want[2], 2e-5)


def test_backward_in_pieces_and_under_deterministic_mode(monkeypatch):
    """The same bits in two runs and with torch's deterministic mode on;
    pieces smaller than the points (the chunked path) sum the same terms
    (float64, 1e-12)."""
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((2, 4, 6, 6)))
    grid = torch.from_numpy(_points(rng, 2, 50, True)).view(2, 5, 10, 2)
    g = torch.from_numpy(rng.standard_normal((2, 4, 5, 10)))

    def run():
        return ts.sample_backward(img, grid, g, False, "zeros")

    one = run()
    assert all(torch.equal(a, b) for a, b in zip(one, run()))
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert all(torch.equal(a, b) for a, b in zip(one, run()))
    finally:
        torch.use_deterministic_algorithms(old)
    monkeypatch.setattr(ts, "BACKWARD_CHUNK_BYTES", 4 * 2 * 4 * 8 * 7)
    pieces = run()
    for a, b in zip(pieces, one):
        _assert_close(a, b, 1e-12)


@pytest.mark.parametrize("src,dst", [((5, 7), (11, 13)), ((12, 9), (5, 4)),
                                     ((1, 3), (4, 6)), ((6, 6), (6, 6))])
def test_bilinear_resize_backward_matches_torch_autograd(src, dst):
    """`BilinearResize` (the DKM decoder's context and `resize_nhwc`):
    forward bit-equal to `F.interpolate`, backward (two matrix products)
    against its autograd in float64, up- and downsampling, within 1e-12 of
    the largest magnitude."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, *src)))
    w = torch.from_numpy(rng.standard_normal((2, 3, *dst)))
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    got = tr.resize_bilinear(a, dst)
    want = F.interpolate(b, size=dst, mode="bilinear", align_corners=False)
    assert torch.equal(got.detach(), want.detach())
    (got * w).sum().backward()
    (want * w).sum().backward()
    _assert_close(a.grad, b.grad, 1e-12)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("n_in,n_out", [(5, 11), (12, 5), (1, 4), (6, 6),
                                        (7, 14)])
def test_bilinear_taps_are_interpolate(n_in, n_out, align_corners):
    """`bilinear_taps` (the DKM resize's backward, gim_loftr's 2x FPN
    upsampling) applied to float64 rows equals `F.interpolate(mode=
    "linear")` within 1e-12 of the largest magnitude, both
    `align_corners`."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 2, n_in)))
    want = F.interpolate(x, size=n_out, mode="linear",
                         align_corners=align_corners)
    got = x @ tr.bilinear_taps(n_in, n_out, align_corners).t()
    _assert_close(got, want, 1e-12)


def test_ordered_index_add_is_index_add_in_index_order():
    """The ordered sum (the dense loss's label scatter and the sampling
    backward's image gradient): each destination's rows summed from zero
    in index order, exactly as a sequential loop, then added to the
    accumulator once; float64 and float32, repeated destinations
    included."""
    rng = np.random.default_rng(6)
    for dt in (torch.float64, torch.float32):
        idx = torch.from_numpy(rng.integers(0, 7, 50))
        val = torch.from_numpy(rng.standard_normal((50, 3))).to(dt)
        acc = torch.from_numpy(rng.standard_normal((9, 3))).to(dt)
        seq = torch.zeros_like(acc)
        for i, v in zip(idx.tolist(), val):
            seq[i] += v
        got = ts.ordered_index_add_(acc.clone(), idx, val)
        assert torch.equal(got, acc + seq)
        cnt = ts.ordered_index_add_(torch.zeros(9, dtype=dt), idx,
                                    torch.ones(50, dtype=dt))
        assert torch.equal(cnt, torch.bincount(idx, minlength=9).to(dt))
