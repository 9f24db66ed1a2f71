"""`pairs` traffic: one client hands `Matcher.match` a batch of the pool,
waits until the matches (keypoints, confidences, validity) are on the
host, then hands it the next; hloc's matching, the demo and localisation
wait on each pair in this way."""

from __future__ import annotations

from benchmark.harness.inputs import batch

RESULT = ("kpts0", "kpts1", "conf", "valid")


def to_host(res) -> dict:
    return {k: getattr(res, k).cpu().numpy() for k in RESULT}


def warmup(prog, batches: list, traffic: dict) -> None:
    """One call on a batch of each content shape (the device shapes are
    the same for all; the masks and extents differ)."""
    seen = {}
    for i, b in enumerate(batches):
        seen.setdefault((int(b["mask0"][0].sum(0).max()),
                         int(b["mask0"][0].sum(1).max())), i)
    for i in seen.values():
        to_host(prog.match(batches[i]))


def run_window(prog, batches: list, traffic: dict, window) -> dict:
    """Drive the window; returns {call index: (batch, host outputs)} of the
    calls the check reads."""
    size = int(traffic["batch"])
    kept = {}
    while True:
        b = batch(batches, window.index)
        t = window.start()
        out = to_host(prog.match(b))
        if window.capturing:
            kept[window.index] = (b, out)
        if not window.end(t, size):
            return kept
