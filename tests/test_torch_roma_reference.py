"""The benchmark's plain reference of gim_roma (`benchmark/reference/
gim_roma.py`) against the port on the CPU, at a small size with every
width kept (the images, DINOv2's depth and the sample budget cut): the
cell `roma-match` run and judged, the port against the reference with
DINOv2's raw parameters drawn, and two faults the judge must catch.
On the CPU both sides run the same float32 math, K2 and K3 as their plain
versions, so the port reads far inside every limit."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import registry
from benchmark.harness.cell import merge, run_cell
from benchmark.harness.inputs import batch, make_batches
from benchmark.harness.weights import seeded_state_dict
from benchmark.heads import gim_roma as head
from benchmark.heads.gimconfig import gim_config
from benchmark.reference import gim_roma as ref_mod
from gim_tpu_torch.api import build_model

SEED = 2**31 + 77            # a seed beyond 32 signed bits
DEPTH = 2
ROMA = {
    "config": {
        "gim_config": {"roma": {"coarse_res": 56, "upsample_res": [112, 112],
                                "dino_depth": DEPTH, "num_samples": 256}},
        # the CPU runs K2's and K3's plain versions, which the launch
        # counters skip
        "launches_per_pair": {"refiner_block": 0, "flash_attention": 0}},
    "traffic": {"canvas": 96, "content": [[72, 96], [96, 72]], "pool": 4,
                "check_from": 1, "check_calls": 1},
}


def small_cell():
    cell = registry.cell("roma-match")
    return (merge(cell.config, ROMA["config"]),
            merge(cell.traffic, ROMA["traffic"]))


class Captured:
    """A window that captures every call as call 0."""

    capturing = True
    index = 0


def run_port(cfg, state, b):
    """The port's outputs of one call, as the check reads them."""
    prog = head.Program(cfg, state, "cpu", Captured())
    try:
        res = prog.match(b)
    finally:
        prog.close()
    return {**prog.kept[0], "kpts0": res.kpts0, "kpts1": res.kpts1,
            "conf": res.conf, "valid": res.valid}


def test_cell_is_correct_far_inside_its_limits():
    r = run_cell("roma-match", SEED, 0.5, False, device="cpu",
                 overrides=ROMA)
    assert r.correct, r.checked
    assert r.attempted >= 1
    assert set(r.checked) == {"cert_gap", "match_miss", "cls_gap",
                              "anchor_miss", "refiner_block_launch_gap",
                              "flash_attention_launch_gap"}
    # read beside the limited numbers, not limited (PERF.md section 2)
    assert {"warp_gap", "anchor_gap"} <= set(r.readings)
    for k, (value, limit) in r.checked.items():
        assert value <= limit / 10 or value == limit == 0, (k, value, limit)
    assert set(r.metrics) >= {"pairs_per_s", "setup_s"}


def test_skeleton_leaves_out_only_the_raw_parameters():
    """The reference's drawn state dict is the port's, key for key and
    shape for shape, but for DINOv2's class token, position table and
    layer scales."""
    cfg, _ = small_cell()
    port = build_model("gim_roma", gim_config(cfg)).state_dict()
    mine = ref_mod.skeleton(cfg).state_dict()
    left = [k for k in port if k not in mine]
    assert left == ["dinov2.cls_token", "dinov2.pos_embed",
                    *(f"dinov2.blocks.{i}.ls{j}.gamma"
                      for i in range(DEPTH) for j in (1, 2))]
    assert [k for k in port if k in mine] == list(mine)
    assert all(port[k].shape == mine[k].shape for k in mine)


@pytest.fixture(scope="module")
def drawn():
    """The small cell's configuration, the benchmark's weights for it and
    its first pair."""
    cfg, traffic = small_cell()
    return (cfg, seeded_state_dict(ref_mod.skeleton(cfg), SEED, "cpu"),
            batch(make_batches(traffic, SEED), 0))


def test_port_agrees_with_reference_on_drawn_raw_parameters(drawn):
    """Drawn position table, class token and layer scales, loaded into
    both sides: they reach the coarse logits, and the port still reads
    far inside every limit."""
    cfg, state, b = drawn
    full = build_model("gim_roma", gim_config(cfg)).state_dict()
    g = torch.Generator().manual_seed(19)
    drawn = {k: (torch.randn(full[k].shape, generator=g) * 0.5
                 + (1.0 if k.endswith("gamma") else 0.0))
             for k in full if ref_mod.raw(k)}
    got = run_port(cfg, {**state, **drawn}, b)
    built = run_port(cfg, state, b)
    assert (got["cls"] - built["cls"]).abs().max() > 1e-2

    ref = ref_mod.Reference(cfg, {**state, **drawn}, "cpu")
    for k, v in drawn.items():
        assert torch.equal(ref.model.state_dict()[k], v), k
    limits = cfg["limits"]["all"]
    for k, v in ref.judge(b, got).items():
        if k in limits:
            assert v <= limits[k] / 10, (k, v, limits[k])


def force_anchors(prog):
    """At every fourth coarse pixel, the class with the lowest logit
    raised one above the largest: the port's anchor there is one the
    reference scores far below its best, no tie."""
    dec = prog.model.decoder.embedding_decoder
    forward = dec.forward

    def forced(*args, **kwargs):
        cls, cert = forward(*args, **kwargs)
        flat = cls.clone().view(-1, cls.shape[-1])
        rows = torch.arange(0, flat.shape[0], 4)
        low = flat[rows].argmin(-1)
        flat[rows, low] = flat[rows].amax(-1) + 1.0
        return flat.view(cls.shape), cert

    dec.forward = forced


def skip_dinov2_block(prog):
    prog.model.dinov2.blocks[1] = torch.nn.Identity()


def pick_neighbour(probs):
    """A fault in the port's anchor selection alone: the class next to the
    argmax, the logits left as they are."""
    return (probs.argmax(dim=-1) + 1).clamp(max=probs.shape[-1] - 1)


@pytest.mark.parametrize("fault,fails", [
    (force_anchors, {"anchor_miss"}),
    (skip_dinov2_block, {"cls_gap"}),
])
def test_judge_catches_a_fault(fault, fails):
    r = run_cell("roma-match", SEED, 0.5, False, device="cpu",
                 overrides=ROMA, fault=fault)
    assert not r.correct
    failed = {k for k, (v, lim) in r.checked.items() if not v <= lim}
    assert failed & fails, r.checked
    if fault is force_anchors:
        # one element in 4 x 4096 moved: the logits' 99.9th percentile
        # does not see it, the anchors do
        assert r.readings["anchor_miss"] == pytest.approx(0.25, abs=0.02)
        assert r.readings["cls_gap"] <= r.checked["cls_gap"][1]


def test_judge_reads_the_anchors_the_port_picked(drawn, monkeypatch):
    """A fault in the port's anchor selection alone, its logits left as
    they are: `anchor_miss` judges the anchors `pick_anchors` returned,
    not an argmax taken again over the captured logits."""
    from gim_tpu_torch.models.roma import model as roma_model

    cfg, state, b = drawn
    # in place before the head wraps the port's selection
    monkeypatch.setattr(roma_model, "pick_anchors", pick_neighbour)
    got = run_port(cfg, state, b)
    assert roma_model.pick_anchors is pick_neighbour     # restored
    readings = ref_mod.Reference(cfg, state, "cpu").judge(b, got)
    limits = cfg["limits"]["all"]
    assert readings["cls_gap"] <= limits["cls_gap"] / 10
    assert readings["anchor_miss"] > 0.5 > limits["anchor_miss"]


def test_judge_holds_the_port_sampling_to_the_reference(drawn, monkeypatch):
    """The port's matches drawn in reverse slot order, its dense output
    left as it is: the judge draws from that output with the reference's
    sampling, and every slot differs."""
    import gim_tpu_torch.api as api

    cfg, state, b = drawn
    sample = api.sample_matches

    def reversed_slots(*args, **kwargs):
        return tuple(t.flip(0) for t in sample(*args, **kwargs))

    monkeypatch.setattr(api, "sample_matches", reversed_slots)
    got = run_port(cfg, state, b)
    readings = ref_mod.Reference(cfg, state, "cpu").judge(b, got)
    limits = cfg["limits"]["all"]
    assert readings["cert_gap"] <= limits["cert_gap"] / 10
    assert readings["match_miss"] > 0.9 > limits["match_miss"]


@pytest.mark.parametrize("mode", ["threshold_balanced", "threshold"])
def test_draws_are_the_pixels_sample_matches_draws(mode):
    from benchmark.reference.frozen.dkm_model import sample_matches

    g = torch.Generator().manual_seed(5)
    warp = torch.rand(24, 48, 4, generator=g) * 2 - 1
    cert = torch.rand(24, 48, generator=g) * 0.1
    got = sample_matches(warp, cert, 100, 0.05, mode,
                         generator=torch.Generator().manual_seed(11))
    idx, valid = ref_mod.draws(warp, cert, 100, 0.05, mode,
                               torch.Generator().manual_seed(11))
    want = (warp.reshape(-1, 4)[idx], cert.reshape(-1)[idx], valid)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_match_miss_holds_a_certainty_rounded_across_the_threshold():
    """One certainty on the sampling threshold in the reference and one
    step above it in the port: drawn from each side's own certainty, the
    matches part slot for slot; drawn from the port's, they agree."""
    from benchmark.reference.frozen.dkm_model import gumbel
    from benchmark.reference.gim_dkm import match_miss

    H, W, num, th = 32, 64, 64, 0.05
    g = torch.Generator().manual_seed(3)
    warp = torch.rand(H, W, 4, generator=g) * 2 - 1
    ref_cert = (torch.rand(H, W, generator=g) * 2 * th).view(-1)
    # the pixel the first Gumbel draws rank 33rd: weighted by its
    # certainty, not 1, it falls far, and each pixel it passes takes the
    # second draw of the rank above
    first = gumbel(H * W, torch.Generator().manual_seed(ref_mod.SAMPLE_SEED),
                   "cpu")
    k = int(first.argsort(descending=True)[32])
    ref_cert[k] = th
    port_cert = ref_cert.clone()
    port_cert[k] = torch.nextafter(ref_cert[k], torch.tensor(1.0))

    def matched(source, cert):
        idx, valid = ref_mod.draws(
            warp, source.view(H, W), num, th, "threshold_balanced",
            torch.Generator().manual_seed(ref_mod.SAMPLE_SEED))
        m = warp.reshape(-1, 4)[idx] * 100               # pixels
        return {"kpts0": m[:, :2], "kpts1": m[:, 2:],
                "conf": cert[idx], "valid": valid}

    port = matched(port_cert, port_cert)
    assert match_miss(port, matched(ref_cert, ref_cert)) > 0.5
    assert match_miss(port, matched(port_cert, ref_cert)) == 0


def test_anchor_shortfall_counts_only_what_passes_the_tie_margin():
    m = ref_mod.TIE_MARGIN
    cls = torch.tensor([[[[0.0, 5.0, 5.0 - m / 2, 1.0]]]])       # (1,1,1,4)
    for mode, short in ((1, 0.0), (2, m / 2), (3, 4.0), (0, 5.0)):
        got = ref_mod.anchor_shortfall(cls, torch.tensor([[[mode]]]))
        assert float(got) == pytest.approx(short, abs=1e-6)
    # the port's argmax is the softmax's, first index on ties
    tie = torch.tensor([[[[1.0, 3.0, 3.0, 2.0]]]])
    assert int(ref_mod.anchors(tie)) == 1


def test_the_cell_resolves_to_its_files_and_metrics():
    cell = registry.cell("roma-match")
    assert cell.config["head"] == cell.config_name == "gim_roma"
    assert cell.spec["chips"] == 1 and cell.traffic["kind"] == "pairs"
    assert registry.head("gim_roma") is head
    assert registry.reference("gim_roma") is ref_mod
    assert {m["name"] for m in cell.end_to_end} == {
        "pairs_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "roma.vgg_ms", "roma.dinov2_ms", "roma.match_decoder_ms",
        "roma.refiner_ms", "flash_attention_roofline",
        "refiner_block_roofline", "device.idle", "mfu"}
    for m in cell.per_layer:
        assert callable(registry.metric(m["name"]).read)
        assert m["moves"] == "pairs_per_s"
