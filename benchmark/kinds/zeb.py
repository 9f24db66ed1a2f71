"""`zeb` traffic: `eval/zeb.evaluate` over the pool's batches, as the ZEB
CLI runs it, with its RANSAC preset (`RANSAC_ZOO`). A call is one batch:
its matches, then `pair_metrics` (the pose on the device) and the metric
rows on the host. The window's stream hands `evaluate` the next batch only
when the last one's rows are on the host, so a call's end is its rows'
arrival.

The time from entering `pair_metrics` to a batch's rows being on the host
(the pose and its host copies) is summed over the window for
`zeb.pose_ms`. For the calls the check reads, the matches and the pose
that `estimate_pose` returned are kept beside the rows.
"""

from __future__ import annotations

import functools
import time

from benchmark.harness.inputs import batch

RESULT = ("kpts0", "kpts1", "conf", "valid")
POSE_SPAN = "zeb.pose"


def _evaluate(match, batches, traffic: dict, on_pose=None, on_solve=None):
    """`evaluate` over `batches`; `on_pose(t)` hears when each batch enters
    `pair_metrics`, `on_solve(pose)` what `estimate_pose` returned."""
    from gim_tpu_torch.eval import zeb as E

    n_hyp, use_conf = E.RANSAC_ZOO[traffic["ransac"]]
    old_metrics, old_pose = E.pair_metrics, E.estimate_pose
    if on_pose is not None:
        @functools.wraps(old_metrics)
        def timed(*args, **kwargs):
            on_pose(time.perf_counter())
            return old_metrics(*args, **kwargs)
        E.pair_metrics = timed
    if on_solve is not None:
        @functools.wraps(old_pose)
        def solved(*args, **kwargs):
            out = old_pose(*args, **kwargs)
            on_solve(out)
            return out
        E.estimate_pose = solved
    try:
        return E.evaluate(match, batches, num_hypotheses=n_hyp,
                          use_conf=use_conf, progress=False)
    finally:
        E.pair_metrics, E.estimate_pose = old_metrics, old_pose


def warmup(prog, batches: list, traffic: dict) -> None:
    calls = max(1, -(-2 // int(traffic["batch"])))   # both content shapes
    _evaluate(prog.match, (batch(batches, i) for i in range(calls)),
              traffic)


def run_window(prog, batches: list, traffic: dict, window) -> dict:
    """Drive the window; returns {call index: (batch, outputs)} of the
    calls the check reads, the outputs being the matches, the pose and
    the batch's metric rows, on the host; `window.host_s[POSE_SPAN]`
    sums the pose time over the window."""
    size = int(traffic["batch"])
    matches, poses = {}, {}
    pose_s = {"entered": 0.0, "total": 0.0}

    def match(b):
        res = prog.match(b)
        if window.capturing:
            matches[window.index] = {k: getattr(res, k).cpu()
                                     for k in RESULT}
        return res

    def stream():
        while True:
            b = batch(batches, window.index)
            t = window.start()
            yield b
            # resumed when `evaluate` asks for the next batch: this
            # batch's rows are on the host
            pose_s["total"] += time.perf_counter() - pose_s["entered"]
            if not window.end(t, size):
                return

    def entered(t):
        pose_s["entered"] = t

    def solved(pose):
        if window.capturing:
            poses[window.index] = {k: pose[k].cpu()
                                   for k in ("R", "t", "success")}

    rows = _evaluate(match, stream(), traffic, on_pose=entered,
                     on_solve=solved)
    window.host_s[POSE_SPAN] = pose_s["total"]
    kept = {}
    for i, m in matches.items():
        kept[i] = (batch(batches, i),
                   {**m, "pose": poses[i],
                    "rows": rows[i * size:(i + 1) * size]})
    window.rows = len(rows)
    return kept
