"""A run whose timed path is broken underneath comes out not correct:
an answer altered where it is produced (a match end moved by a pixel, a
pose error moved by two degrees), half of a batch left out (its second
half answered with the first half's matches, or its poses), half of the
keypoints left out, and a cheaper pose search (fewer hypotheses)."""

import dataclasses

import pytest
import torch

from benchmark.harness.cell import run_cell
from benchmark.tests.small import OVERRIDES, SEED

ZEB_CELLS = ["dkm-zeb", "lightglue-zeb"]


def moved_end(prog):
    inner = prog.match

    def match(b):
        r = inner(b)
        return dataclasses.replace(r, kpts1=r.kpts1 + 1.0)
    prog.match = match


def half_batch(prog):
    inner = prog.match

    def match(b):
        r = inner(b)
        h = r.kpts0.shape[0] // 2
        return type(r)(*(torch.cat([t[:h], t[:h]]) for t in (
            r.kpts0, r.kpts1, r.conf, r.valid)))
    prog.match = match


def half_keypoints(api, monkeypatch):
    """SuperPoint keeps half of its valid keypoints."""
    inner = api.extract

    def extract(*args, **kwargs):
        out = dict(inner(*args, **kwargs))
        valid = out["valid"].clone()
        valid[:, valid.shape[1] // 2:] = False
        out["valid"] = valid
        return out
    monkeypatch.setattr(api, "extract", extract)


@pytest.mark.parametrize("name", ["dkm-match", "lightglue-match",
                                  "dkm-zeb", "lightglue-zeb"])
def test_altered_match_is_caught(name):
    r = run_cell(name, SEED, 0.5, False, device="cpu",
                 overrides=OVERRIDES[name], fault=moved_end)
    assert not r.correct
    assert r.checked["match_miss"][0] > r.checked["match_miss"][1]


def test_half_batch_left_out_is_caught():
    r = run_cell("lightglue-zeb", SEED, 0.5, False, device="cpu",
                 overrides=OVERRIDES["lightglue-zeb"], fault=half_batch)
    assert not r.correct


@pytest.mark.parametrize("name", ["lightglue-match", "lightglue-zeb"])
def test_half_keypoints_left_out_is_caught(monkeypatch, name):
    from gim_tpu_torch import api

    half_keypoints(api, monkeypatch)
    r = run_cell(name, SEED, 0.5, False, device="cpu",
                 overrides=OVERRIDES[name])
    assert not r.correct
    assert r.checked["kpt_miss"][0] > r.checked["kpt_miss"][1]


@pytest.mark.parametrize("name", ZEB_CELLS)
def test_altered_pose_row_is_caught(monkeypatch, name):
    from gim_tpu_torch.eval import zeb as E

    inner = E.pair_metrics

    def pair_metrics(*args, **kwargs):
        m = inner(*args, **kwargs)
        return {**m, "R_errs": m["R_errs"] + 2.0}
    monkeypatch.setattr(E, "pair_metrics", pair_metrics)
    r = run_cell(name, SEED, 0.5, False, device="cpu",
                 overrides=OVERRIDES[name])
    assert not r.correct
    assert r.checked["row_gap"][0] > r.checked["row_gap"][1]


def _fewer_hypotheses(E, monkeypatch):
    inner = E.estimate_pose

    def estimate_pose(*args, **kwargs):
        args = list(args)
        args[6] = max(1, args[6] // 16)      # num_hypotheses
        return inner(*args, **kwargs)
    monkeypatch.setattr(E, "estimate_pose", estimate_pose)


def _half_poses(E, monkeypatch):
    inner = E.estimate_pose

    def estimate_pose(*args, **kwargs):
        out = dict(inner(*args, **kwargs))
        h = out["R"].shape[0] // 2
        for k in ("R", "t", "success"):
            out[k] = torch.cat([out[k][:h], out[k][:h], out[k][2 * h:]])
        return out
    monkeypatch.setattr(E, "estimate_pose", estimate_pose)


@pytest.mark.parametrize("name,fault", [
    ("dkm-zeb", _fewer_hypotheses), ("lightglue-zeb", _fewer_hypotheses),
    ("lightglue-zeb", _half_poses)])
def test_wrong_pose_is_caught(monkeypatch, name, fault):
    """A pose that RANSAC did not find as the configuration states it (a
    sixteenth of the hypotheses; half a batch given the other half's
    poses) fails the pose's numbers."""
    from gim_tpu_torch.eval import zeb as E

    fault(E, monkeypatch)
    r = run_cell(name, SEED, 0.5, False, device="cpu",
                 overrides=OVERRIDES[name])
    assert not r.correct
    assert (r.checked["row_gap"][0] > r.checked["row_gap"][1]
            or r.checked["gain_deficit"][0] > r.checked["gain_deficit"][1])
