"""LightGlue's assignment and mutual filter: frozen copy of the port's
`ops/matching.py` (ref matchers/lightglue.py:250-304). Every argmax takes
the first maximum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor,
                               z1: torch.Tensor) -> torch.Tensor:
    """(N, L+1, S+1) log-assignment with dustbins
    (`gim_tpu/ops/matching.py:180-194`). sim: (N, L, S); z0: (N, L), z1:
    (N, S) matchability logits."""
    N, L, S = sim.shape
    certainties = F.logsigmoid(z0)[..., None] + F.logsigmoid(z1)[:, None, :]
    scores0 = torch.log_softmax(sim, dim=2)
    scores1 = torch.log_softmax(sim, dim=1)
    scores = sim.new_zeros((N, L + 1, S + 1))
    scores[:, :L, :S] = scores0 + scores1 + certainties
    scores[:, :-1, -1] = F.logsigmoid(-z0)
    scores[:, -1, :-1] = F.logsigmoid(-z1)
    return scores


def filter_matches(scores: torch.Tensor, threshold: float):
    """Mutual nearest neighbours above `threshold` on the (N, L+1, S+1)
    log-assignment (`gim_tpu/ops/matching.py:197-217`). Returns m0 (N, L),
    m1 (N, S) (partner index, -1 if none), mscores0, mscores1."""
    inner = scores[:, :-1, :-1]
    max0, m0 = inner.max(dim=2)
    m1 = inner.argmax(dim=1)
    ind0 = torch.arange(m0.shape[1], device=scores.device)[None]
    ind1 = torch.arange(m1.shape[1], device=scores.device)[None]
    mutual0 = ind0 == torch.gather(m1, 1, m0)
    mutual1 = ind1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, max0.exp(), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    return (torch.where(valid0, m0, -1), torch.where(valid1, m1, -1),
            mscores0, mscores1)
