"""Match sampling shared by gim_dkm and gim_roma (PyTorch port).

Port of `gim_tpu/models/dkm/model.py:221-263` (`sample_matches`; ref
networks/dkm/models/dkm.py:583-620). The rest of the DKM matcher (encoder,
DFN decoder, model wiring) comes with the gim_dkm slice.
"""

from __future__ import annotations

import torch

from gim_tpu_torch.models.dkm.blocks import kde_density


def gumbel(n: int, generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """n standard Gumbel draws, -log(-log(u)) with u in [tiny, 1) as
    `jax.random.gumbel` draws them, from `generator` (on its device),
    returned on `device`."""
    u = torch.rand(n, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def sample_matches(warp: torch.Tensor, certainty: torch.Tensor,
                   num: int = 5000, sample_thresh: float = 0.05,
                   mode: str = "threshold_balanced", *,
                   generator: torch.Generator | None = None,
                   noise: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Certainty-weighted sampling with balanced KDE resampling.

    warp: (hs, ws2, 4); certainty: (hs, ws2). Returns (matches (num, 4)
    normalized, certainty (num,), valid (num,)). Sampling without
    replacement is the Gumbel-top-k trick: `noise` = (g1, g2), Gumbel
    draws of sizes (hs * ws2,) and (min(4 num, hs * ws2),) -- the JAX
    package draws them with `jax.random.gumbel` at `:240-242` and `:260`;
    without `noise` they come from `generator`.
    """
    matches = warp.reshape(-1, 4)
    cert_raw = certainty.reshape(-1)
    if "threshold" in mode:
        cert = torch.where(cert_raw > sample_thresh, 1.0, cert_raw)
    else:
        cert = cert_raw
    expansion = 4 if "balanced" in mode else 1
    # a small dense grid can hold fewer cells than the sample budget
    n_grab = min(expansion * num, cert.shape[0])
    num = min(num, n_grab)
    if noise is None:
        if generator is None:
            raise ValueError("sample_matches needs a generator or noise")
        g1 = gumbel(cert.shape[0], generator, cert.device)
        g2 = gumbel(n_grab, generator, cert.device)
    else:
        g1, g2 = (n.to(cert.device, torch.float32) for n in noise)

    logp = torch.log(cert.clamp_min(1e-12))
    idx = torch.topk(logp + g1, n_grab).indices
    good_matches = matches[idx]
    good_cert = cert_raw[idx]
    good_w = cert[idx]
    if "balanced" not in mode:
        return good_matches[:num], good_cert[:num], good_w[:num] > 0

    density = kde_density(good_matches, std=0.1)
    p = 1.0 / (density + 1.0)
    p = torch.where(density < 10, 1e-7, p)
    idx2 = torch.topk(torch.log(p.clamp_min(1e-30)) + g2, num).indices
    return good_matches[idx2], good_cert[idx2], good_w[idx2] > 0
