"""The traffic generator: a pool of image pairs drawn from the seed.

Every pair is a pair of host float32 canvases in `data/zeb.batch_pairs`'s
layout (`color0`, `color1` (3, S, S); `mask0`, `mask1` (S, S); `scale0`,
`scale1`, `K0`, `K1`, `T_0to1`, an identifier and covisibilities). The
content (h, w) of each pair is one of the traffic file's `content`
shapes, each taken by an equal share of the pool in an order drawn from
the seed, so every seed gives the same set of sizes. Image 0 holds blocky
texture (blocks of `block` px); image 1 is the same texture under a
sideways move of two planes: its left half moved by `shift_px[0]`, its
right half by `shift_px[1]` (R = I, t along -x, as ZEB's pose rows read
it). The pool is stacked into batches of `batch` pairs once, at set-up,
so the window does no host work of the harness's; calls take the
batches in order and cycle them.
"""

from __future__ import annotations

import numpy as np

BATCH_KEYS = ("color0", "color1", "mask0", "mask1", "scale0", "scale1",
              "K0", "K1", "T_0to1")


def make_pair(rng: np.random.Generator, canvas: int, content: tuple,
              shift_px: tuple, block: int, focal: float,
              identifier: str) -> dict:
    S = canvas
    h, w = content
    tex = np.repeat(np.repeat(
        rng.random((3, -(-h // block), -(-w // block)), dtype=np.float32),
        block, 1), block, 2)[:, :h, :w]
    c0 = np.zeros((3, S, S), np.float32)
    c0[:, :h, :w] = tex
    c1 = np.zeros_like(c0)
    half = w // 2
    a, b = shift_px
    c1[:, :h, a:half] = tex[:, :, :half - a]
    c1[:, :h, half + b:w] = tex[:, :, half:w - b]
    mask = np.zeros((S, S), bool)
    mask[:h, :w] = True
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -1.0
    return {"color0": c0, "color1": c1, "mask0": mask, "mask1": mask.copy(),
            "scale0": np.ones(2, np.float32), "scale1": np.ones(2, np.float32),
            "K0": K, "K1": K.copy(), "T_0to1": T, "identifier": identifier,
            "covisible0": 0.5, "covisible1": 0.5}


def make_pool(traffic: dict, seed: int) -> list[dict]:
    """The traffic file's pool of pairs for `seed`."""
    n = int(traffic["pool"])
    shapes = [tuple(s) for s in traffic["content"]]
    if n % len(shapes):
        raise ValueError(f"pool {n} is not a multiple of {len(shapes)} "
                         "content shapes")
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.repeat(np.arange(len(shapes)),
                                      n // len(shapes)))
    return [make_pair(rng, int(traffic["canvas"]), shapes[k],
                      tuple(traffic["shift_px"]), int(traffic["block"]),
                      float(traffic["focal"]), f"s{seed}#{i:03d}")
            for i, k in enumerate(order)]


def make_batches(traffic: dict, seed: int) -> list[dict]:
    """The pool for `seed` stacked into batches of the traffic's `batch`
    pairs, as `data/zeb.batch_pairs` stacks them."""
    pool = make_pool(traffic, seed)
    size = int(traffic["batch"])
    if len(pool) % size:
        raise ValueError(f"pool {len(pool)} is not a multiple of the "
                         f"batch {size}")
    out = []
    for i in range(0, len(pool), size):
        pairs = pool[i:i + size]
        b = {k: np.stack([p[k] for p in pairs]) for k in BATCH_KEYS}
        for k in ("identifier", "covisible0", "covisible1"):
            b[k] = [p[k] for p in pairs]
        out.append(b)
    return out


def batch(batches: list[dict], call: int) -> dict:
    """Call `call`'s batch: the batches in order, cycled."""
    return batches[call % len(batches)]
