"""The port's semantic segmentation (`models/semseg.py`) against the JAX
package's on the CPU, float32, on shared weights: the port's seeded
state dict (BatchNorm statistics randomised) through the JAX package's
`port_semseg`, with no key left over.

Tolerances: the resize counterpart within 1e-6 of JAX's (float32
rounding of one two-tap blend); the logits at 64 x 64 (full width: deep
stem, 16 bottlenecks, PPM, 150 classes) within 1e-4 of their largest
magnitude (float32 sums over 50 layers); the segmenter's masks equal
wherever JAX's top-two logit margin exceeds that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gim_tpu.models import semseg as js
from gim_tpu.weights import port as jport
from gim_tpu_torch.models import semseg as ts
from gim_tpu_torch.weights import port as tport

HIGH = jax.default_matmul_precision("highest")


@pytest.mark.parametrize("src,dst", [((1, 1), (9, 13)), ((2, 2), (9, 13)),
                                     ((3, 3), (8, 8)), ((6, 6), (17, 23)),
                                     ((8, 8), (64, 64)), ((5, 7), (5, 7))])
def test_bilinear_resize_is_jax_image_resize(src, dst):
    """`jax.image.resize(..., "bilinear")` (half-pixel, edge taps
    renormalised) against `F.interpolate(bilinear, align_corners=False)`
    (edge clamped) for the upsampling the model does, size-1 maps and the
    identity included."""
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst,
                        mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def shared():
    """The port's model (seeded, BatchNorm statistics and affine terms
    randomised) and the same weights as JAX variables."""
    model = ts.build_segmenter(generator=torch.Generator().manual_seed(3),
                               device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                m.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items()
           if k.startswith("decoder.")}
    assert len(enc) + len(dec) == len(sd)
    variables = jport.port_semseg(enc, dec)          # asserts no leftover
    return model, variables


def test_port_semseg_gives_the_jax_tree(shared):
    _, variables = shared
    init = js.init_params(jax.random.PRNGKey(0), (32, 32))
    flat = lambda t: {k: v.shape for k, v in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(variables) == flat(dict(init))


def _jax_logits(variables, x):
    with HIGH:
        out = jax.jit(js.SegmentationModel().apply)(variables, jnp.asarray(x))
    return np.asarray(out)                          # (B, H, W, 150)


def test_logits_match_jax(shared):
    model, variables = shared
    x = np.random.default_rng(5).random((2, 3, 64, 64)).astype(np.float32)
    want = _jax_logits(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 64, 64, 150)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_segmenter_mask_matches_jax(shared):
    """`make_segmenter` on a 50 x 70 frame at img_size 64 (cv2 resizes on
    the host in both): the masks of the two classes JAX predicts most."""
    model, variables = shared
    rgb = np.random.default_rng(6).integers(0, 256, (50, 70, 3), np.uint8)
    import cv2

    small = cv2.resize(rgb, (64, 48)).astype(np.float32) / 255.0
    logits = _jax_logits(variables, np.transpose(small, (2, 0, 1))[None])[0]
    classes = tuple(int(c) for c in np.argsort(
        -np.bincount(logits.argmax(-1).ravel(), minlength=150))[:2])
    want = js.make_segmenter(variables, 64, classes)(rgb)
    got = ts.make_segmenter(model, 64, classes)(rgb)
    assert got.shape == want.shape == (50, 70) and got.dtype == bool
    assert 0 < want.sum() < want.size
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4 * np.abs(logits).max()
    clear = cv2.resize(clear.astype(np.uint8), (70, 50),
                       interpolation=cv2.INTER_NEAREST).astype(bool)
    assert np.array_equal(got[clear], want[clear])
    assert clear.mean() > 0.9


def test_reference_checkpoint_pair_loads_strictly(shared, tmp_path):
    """The reference's encoder and decoder files (mit_semseg keys, no
    `num_batches_tracked`, the classifier and the deepsup branch beside)
    load through `load_semseg_state_dict` into the port's model."""
    model, _ = shared
    sd = model.state_dict()
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.") and "num_batches" not in k}
    enc["fc.weight"] = torch.zeros(1000, 2048)
    enc["fc.bias"] = torch.zeros(1000)
    dec = {k[len("decoder."):]: v for k, v in sd.items()
           if k.startswith("decoder.") and "num_batches" not in k}
    dec["cbr_deepsup.0.weight"] = torch.zeros(512, 1024, 3, 3)
    dec["conv_last_deepsup.weight"] = torch.zeros(150, 512, 1, 1)
    torch.save(enc, tmp_path / "encoder_epoch_20.pth")
    torch.save(dec, tmp_path / "decoder_epoch_20.pth")
    got = tport.load_semseg_state_dict(str(tmp_path / "encoder_epoch_20.pth"),
                                       str(tmp_path / "decoder_epoch_20.pth"))
    loaded = ts.build_segmenter(got, device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for f in tmp_path.iterdir():      # 0.2 GB: free the disk
        f.unlink()


def test_segmenter_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.build_segmenter()
