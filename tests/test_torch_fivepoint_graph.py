"""The 5-point solve as a CUDA graph (`geometry/fivepoint.essential_candidates`).

On the CPU: which calls take the eager solve, and the capture cache's key
and bound, with a stand-in capture. On the card (marker `card`, skipped
without CUDA): a replay's candidates against the eager solve's, bit for
bit, at the shapes of the ZEB pose's two rounds at batch 1 and 16; later
replays leave outputs handed back earlier as they were; only the static
inputs and outputs stay allocated, no cuBLAS workspace among them.

Run the card tests with `python -m pytest tests/test_torch_fivepoint_graph.py
--noconftest -m card` (the test config imports JAX, which the card's
machine may lack; this file imports none).
"""

import numpy as np
import pytest
import torch

from gim_tpu_torch.geometry import fivepoint as fp


def points(shape, seed, device="cpu"):
    """Normalized camera coords (*shape, 5, 2) of both views, from a seed."""
    rng = np.random.default_rng(seed)
    p0, p1 = (torch.from_numpy(rng.uniform(-0.8, 0.8, (*shape, 5, 2))
                               .astype(np.float32)).to(device)
              for _ in range(2))
    return p0, p1


def counts():
    return dict(fp.GRAPHS)


def moved(before):
    return {k: fp.GRAPHS[k] - before[k] for k in before}


class FakeCapture:
    """A capture that records what it was made for; its replay returns a
    marker."""

    def __init__(self):
        self.made = []

    def __call__(self, p0, p1):
        self.made.append((tuple(p0.shape), p0.dtype, p0.device))
        return lambda a, b: ("replayed", tuple(a.shape))


# ---------------------------------------------------------------------------
# CPU: the dispatch and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3,), (2, 8), (1, 64)])
def test_cpu_inputs_take_the_eager_solve(shape):
    p0, p1 = points(shape, 11)
    before = counts()
    E, valid = fp.essential_candidates(p0, p1)
    assert moved(before) == {"captured": 0, "replayed": 0, "eager": 1}
    E_ref, valid_ref = fp.eager_candidates(p0, p1)
    assert E.shape == (*shape, 10, 3, 3) and valid.shape == (*shape, 10)
    assert torch.equal(E, E_ref) and torch.equal(valid, valid_ref)


def test_cache_key_separates_shape_dtype_and_device():
    fake = FakeCapture()
    cache = fp._GraphCache(fake, size=8)
    calls = [((1, 4), torch.float32, "cpu"), ((1, 8), torch.float32, "cpu"),
             ((2, 4), torch.float32, "cpu"), ((1, 4), torch.float64, "cpu"),
             ((1, 4), torch.float32, "meta")]
    for shape, dtype, dev in calls + calls:
        p = torch.zeros((*shape, 5, 2), dtype=dtype, device=dev)
        assert cache(p, p) == ("replayed", (*shape, 5, 2))
    assert fake.made == [((*s, 5, 2), d, torch.device(v)) for s, d, v in calls]
    assert len(cache.entries) == len(calls)


def test_cache_keeps_its_bound_dropping_the_least_recently_used():
    fake = FakeCapture()
    cache = fp._GraphCache(fake, size=2)

    def call(h):
        p = torch.zeros((1, h, 5, 2))
        cache(p, p)

    for h in (1, 2, 1, 3):       # 2 is the least recently used when 3 comes
        call(h)
    assert [k[0][1] for k in cache.entries] == [1, 3]
    call(2)                      # captured again; 1 goes
    assert [k[0][1] for k in cache.entries] == [3, 2]
    assert [m[0][1] for m in fake.made] == [1, 2, 3, 2]
    assert len(cache.entries) == 2 == cache.size


@pytest.fixture
def cpu_as_card(monkeypatch):
    """Treat the CPU as the card for the dispatch; the cache's captures
    are recorded, not made."""
    fake = FakeCapture()
    capturing = {"now": False}
    monkeypatch.setattr(fp, "_GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(fp, "_CACHE", fp._GraphCache(fake))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["now"])
    return fake, capturing


def test_inputs_that_require_grad_never_reach_capture(cpu_as_card):
    fake, _ = cpu_as_card
    p0, p1 = points((2, 4), 12)
    assert fp.essential_candidates(p0, p1)[0] == "replayed"
    assert len(fake.made) == 1

    for grad0, grad1 in ((True, False), (False, True), (True, True)):
        q0 = p0.clone().requires_grad_(grad0)
        q1 = p1.clone().requires_grad_(grad1)
        before = counts()
        E, valid = fp.essential_candidates(q0, q1)
        assert moved(before) == {"captured": 0, "replayed": 0, "eager": 1}
        assert E.requires_grad and E.grad_fn is not None
        assert torch.equal(E.detach(), fp.eager_candidates(p0, p1)[0])
    assert len(fake.made) == 1
    # under no_grad autograd records nothing: the graph serves
    with torch.no_grad():
        out = fp.essential_candidates(p0.clone().requires_grad_(), p1)
    assert out[0] == "replayed" and len(fake.made) == 1


def test_a_capture_underway_or_inputs_of_two_dtypes_take_the_eager_solve(
        cpu_as_card):
    fake, capturing = cpu_as_card
    p0, p1 = points((1, 4), 13)
    capturing["now"] = True
    before = counts()
    E, _ = fp.essential_candidates(p0, p1)
    capturing["now"] = False
    assert torch.equal(E, fp.eager_candidates(p0, p1)[0])
    # the eager solve refuses two dtypes; a capture would have cast p1
    with pytest.raises(RuntimeError, match="same dtype"):
        fp.essential_candidates(p0, p1.double())
    assert moved(before) == {"captured": 0, "replayed": 0, "eager": 2}
    assert fake.made == []


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

# the ZEB pose's two rounds (2048 hypotheses, then the LO round's 512) at
# dkm-zeb's batch 1 and lightglue-zeb's batch 16
CELL_SHAPES = [(1, 2048), (1, 512), (16, 2048), (16, 512)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_replay_equals_the_eager_solve_bit_for_bit(card, shape):
    p0, p1 = points(shape, 100 + shape[0] * shape[1], card)
    before = counts()
    E, valid = fp.essential_candidates(p0, p1)
    E_ref, valid_ref = fp.eager_candidates(p0, p1)
    c = moved(before)
    assert c["eager"] == 0 and c["replayed"] == 1 and c["captured"] <= 1
    assert valid_ref.any()
    assert torch.equal(valid, valid_ref)
    assert torch.equal(E, E_ref)


@pytest.mark.card
@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_a_later_replay_answers_its_own_inputs(card, shape):
    first = fp.essential_candidates(*points(shape, 7, card))
    kept = [t.clone() for t in first]
    q0, q1 = points(shape, 8, card)
    before = counts()
    E, valid = fp.essential_candidates(q0, q1)
    assert moved(before) == {"captured": 0, "replayed": 1, "eager": 0}
    E_ref, valid_ref = fp.eager_candidates(q0, q1)
    assert torch.equal(E, E_ref) and torch.equal(valid, valid_ref)
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not torch.equal(first[0], E)


@pytest.mark.card
def test_only_the_static_buffers_stay_allocated(card):
    shape = (1, 1000)             # a signature no other test captures
    p0, p1 = points(shape, 9, card)
    fp.essential_candidates(*points((1, 999), 10, card))  # the constants
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated(card)
    out = fp.essential_candidates(p0, p1)
    del out
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(card) - a0
    n = shape[0] * shape[1]
    blocks = [n * 5 * 2 * 4] * 2 + [n * 10 * 9 * 4, n * 10]
    static = sum(-(-b // 512) * 512 for b in blocks)
    assert static <= grown <= static + 64 * 1024
