"""Rank-zero logging and benchmark info tables (port of
`gim_tpu/utils/logging.py`).

Replaces the reference's loguru rank-zero wrapper (ref tools/misc.py:26-40)
and styled `hint`/`datainfo` prints (ref tools/__init__.py:28-50) with a
stdlib logger gated on the process's rank in its `torch.distributed`
group (0 when no group is initialised, `parallel/mesh.rank`), where the
JAX package reads `jax.process_index()`.
"""

from __future__ import annotations

import logging
import sys

from gim_tpu_torch.parallel.mesh import rank


def get_logger(name: str = "gim_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s %(levelname)s] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def rank_zero_info(msg: str, logger: logging.Logger | None = None):
    if rank() == 0:
        (logger or get_logger()).info(msg)


def datainfo_table(rows: list[dict]) -> str:
    """Benchmark info table (ref tools/__init__.py:33-50 style)."""
    if not rows:
        return ""
    keys = list(rows[0].keys())
    out = [" | ".join(f"{k:<14}" for k in keys)]
    out.append("-" * (17 * len(keys)))
    for r in rows:
        out.append(" | ".join(f"{str(r[k]):<14}" for k in keys))
    return "\n".join(out)
