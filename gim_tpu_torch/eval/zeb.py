"""ZEB evaluation: metrics, pose and dumps (port of `gim_tpu/eval/zeb.py`).

Per pair: symmetric epipolar errors, the relative pose from the batched
on-device RANSAC (in place of the reference's serial per-pair
cv2.findEssentialMat loop, tools/metrics.py:125-168), pose errors; then
dump files byte-compatible with
`dump/zeb/[T] {weight} {scene:>15} {version}.txt` (the reference's
trainer/lightning.py:258-275), which `cli/analysis.py` and `cli/check.py`
read.

RANSAC's uniforms come from one `torch.Generator` per pair on the eval
device, seeded from the pair identifier's 8-byte blake2s digest (the key
the JAX package builds its threefry stream from), so a dump does not
depend on batching. The stream itself differs from the JAX package's;
`noise` passes given uniforms instead. Across processes (torchrun,
`cli/zeb_eval.py`) each process takes its share of the pairs and the rows
meet through the process group's key-value store
(`gather_rows_multihost`, `barrier_multihost`).
"""

from __future__ import annotations

import hashlib
import os
from datetime import timedelta
from os.path import join

import numpy as np
import torch

from gim_tpu_torch.geometry.epipolar import (essential_from_pose,
                                             symmetric_epipolar_distance)
from gim_tpu_torch.geometry.pose import estimate_pose, relative_pose_error
from gim_tpu_torch.utils.precision import highp
from gim_tpu_torch.utils.profiling import span


@span("gim.zeb.pose")
@torch.no_grad()
@highp
def pair_metrics(kpts0, kpts1, valid, K0, K1, T_0to1, keys,
                 thresh: float = 0.5, num_hypotheses: int = 2048,
                 conf=None, noise=None):
    """All per-pair metrics on the device. Args batched (B, ...); `keys`:
    one (2,) uint32 key per pair (`identifier_key`), each seeding that
    pair's generator on kpts0's device (`seed_of`), unless `noise` gives
    RANSAC's two uniform banks ((B, H, M), (B, max(H // 4, 32), M)).
    Returns a dict of (B, ...) tensors: epi_errs, R_errs, t_errs, t_errs2,
    inliers."""
    E = essential_from_pose(T_0to1)
    epi = symmetric_epipolar_distance(kpts0, kpts1, E, K0, K1)
    generators = None
    if noise is None:
        generators = [torch.Generator(kpts0.device).manual_seed(seed_of(k))
                      for k in keys]
    if conf is None:
        conf = torch.ones(kpts0.shape[:2], device=kpts0.device)
    pose = estimate_pose(kpts0, kpts1, valid, K0, K1, thresh, num_hypotheses,
                         conf=conf, noise=noise, generators=generators)
    t_err, r_err, t_err2 = relative_pose_error(T_0to1, pose["R"], pose["t"])
    ok = pose["success"]
    return {"epi_errs": epi, "R_errs": torch.where(ok, r_err, torch.inf),
            "t_errs": torch.where(ok, t_err, torch.inf),
            "t_errs2": torch.where(ok, t_err2, torch.inf),
            "inliers": pose["inliers"] & valid}


def identifier_key(identifier: str) -> np.ndarray:
    """Deterministic per-pair key from the pair identifier (process- and
    batching-independent, unlike Python's salted hash()): the blake2s
    digest as two uint32, as the JAX package builds it."""
    d = hashlib.blake2s(identifier.encode(), digest_size=8).digest()
    return np.frombuffer(d, dtype=np.uint32).copy()


def seed_of(key) -> int:
    """A generator seed from a (2,) uint32 key: the 8 digest bytes as one
    little-endian integer."""
    k = np.asarray(key, dtype=np.uint32)
    return int(k[0]) | (int(k[1]) << 32)


def format_rows(metrics_rows: list[dict], epi_err_thr: float = 5e-4) -> str:
    """Dump-file text (ref trainer/lightning.py:258-271 format)."""
    out = ("identifiers covisible0 covisible1 R_errs t_errs t_errs2 "
           "Bef.Prec Bef.Num Aft.Prec Aft.Num\n")
    mean = lambda x: sum(x) / max(len(x), 1)
    for r in metrics_rows:
        epi = r["epi_errs"]
        inl = r["inliers"]
        bef = epi < epi_err_thr
        aft = epi[inl] < epi_err_thr
        out += (f'{r["identifier"]} {r["covisible0"]} {r["covisible1"]} '
                f'{r["R_errs"]} {r["t_errs"]} {r["t_errs2"]} ')
        out += f"{mean(bef)} {sum(bef)} {mean(aft)} {sum(aft)}\n"
    return out


def dump_path(out_dir: str, weight: str, scene: str, version: str) -> str:
    return join(out_dir, f"[T] {weight} {scene:>15} {version}.txt")


# The reference's RANSAC zoo (ref test.py:51-59) maps OpenCV estimator
# variants onto the one on-device implementation as presets:
# (num_hypotheses, use match confidences for PROSAC ordering).
RANSAC_ZOO = {
    "RANSAC": (2048, False),
    "FAST": (512, False),
    "MAGSAC": (2048, True),      # sigma-marginalized scoring is always on
    "PROSAC": (2048, True),
    "DEFAULT": (2048, False),
    "ACCURATE": (4096, True),
    "PARALLEL": (2048, True),
}


def evaluate(match, batches, *, ransac_thresh: float = 0.5,
             num_hypotheses: int = 2048, progress: bool = True,
             use_conf: bool = True, noise=None):
    """Run `match(batch) -> MatchResult` over an iterable of batches and
    collect per-pair metric rows (host dicts).

    `batches` yield dicts from `data/zeb.batch_pairs`. Matching, metrics
    and pose run on the device of the matches; the final scalars and the
    per-match epi/inlier vectors cross to the host once per batch.
    RANSAC's generators are seeded per pair from the identifier, so the
    dump is the same however the pairs are batched. `noise`, where given,
    maps a batch's identifiers to RANSAC's two uniform banks instead."""
    rows = []
    for bi, batch in enumerate(batches):
        res = match(batch)
        dev = res.kpts0.device

        def put(k):
            return torch.as_tensor(np.asarray(batch[k]),
                                   dtype=torch.float32).to(dev)

        ids = batch["identifier"]
        m = pair_metrics(res.kpts0, res.kpts1, res.valid, put("K0"),
                         put("K1"), put("T_0to1"),
                         [identifier_key(i) for i in ids], ransac_thresh,
                         num_hypotheses,
                         conf=res.conf if use_conf else None,
                         noise=None if noise is None else noise(ids))
        with span("gim.zeb.rows"):
            m = {k: v.cpu().numpy() for k, v in m.items()}
            valid = res.valid.cpu().numpy()
            for b in range(valid.shape[0]):
                v = valid[b]
                rows.append({
                    "identifier": ids[b],
                    "covisible0": batch["covisible0"][b],
                    "covisible1": batch["covisible1"][b],
                    "epi_errs": m["epi_errs"][b][v],
                    "inliers": m["inliers"][b][v],
                    "R_errs": float(m["R_errs"][b]),
                    "t_errs": float(m["t_errs"][b]),
                    "t_errs2": float(m["t_errs2"][b]),
                })
        if progress:
            print(f"[zeb] batch {bi + 1}: {len(rows)} pairs", flush=True)
    return rows


def _store():
    """The default process group's key-value store, or None outside a
    group of more than one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    from torch.distributed.distributed_c10d import _get_default_store

    return _get_default_store()


_CALLS = {"barrier": 0, "gather": 0}   # per process; ranks call in lockstep
STORE_TIMEOUT = timedelta(minutes=20)   # ranks may be this far apart


def barrier_multihost(name: str) -> None:
    """Cross-process barrier through the process group's key-value store
    (`gim_tpu/eval/zeb.py:160-180`): each rank sets its key and waits,
    with a long timeout, for every rank's. It is not a device collective:
    no NCCL (which refuses two ranks on one card) and no gloo clique,
    whose connect window trips under skew between ranks. A no-op in one
    process."""
    store = _store()
    if store is None:
        return
    import torch.distributed as dist

    n = _CALLS["barrier"]
    _CALLS["barrier"] += 1
    key = f"zeb_barrier/{name}/{n}"
    store.set(f"{key}/{dist.get_rank()}", b"1")
    store.wait([f"{key}/{r}" for r in range(dist.get_world_size())],
               STORE_TIMEOUT)


def gather_rows_multihost(rows: list[dict]) -> list[dict]:
    """Cross-process gather of metric rows (`gim_tpu/eval/zeb.py:183-214`):
    each rank publishes its rows, pickled, under `zeb_rows/{call}/{rank}`
    in the process group's store, then waits for the others' with a long
    timeout; rank order. The rows themselves in one process."""
    store = _store()
    if store is None:
        return rows
    import pickle

    import torch.distributed as dist

    n = _CALLS["gather"]
    _CALLS["gather"] += 1
    store.set(f"zeb_rows/{n}/{dist.get_rank()}", pickle.dumps(rows))
    out = []
    for r in range(dist.get_world_size()):
        key = f"zeb_rows/{n}/{r}"
        store.wait([key], STORE_TIMEOUT)
        out.extend(pickle.loads(store.get(key)))
    return out


def dedup_rows(rows: list[dict]) -> list[dict]:
    """Dedup by identifier then sort (ref trainer/lightning.py:253-255)."""
    seen = {}
    for r in rows:
        seen.setdefault(r["identifier"], r)
    return [seen[k] for k in sorted(seen)]


def write_dump(rows: list[dict], out_dir: str, weight: str, scene: str,
               version: str, epi_err_thr: float = 5e-4) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = dump_path(out_dir, weight, scene, version)
    with open(path, "w") as f:
        f.write(format_rows(dedup_rows(rows), epi_err_thr))
    return path
