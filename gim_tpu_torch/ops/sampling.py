"""Bilinear grid sampling, and SuperPoint's descriptor sampling.

Port of `gim_tpu/ops/sampling.py:20-127`: `safe_l2_normalize`,
`grid_sample` and `sample_descriptors`. The JAX package writes
`grid_sample` as four row gathers because the TPU has no sampler. Its
rule is torch's (`F.grid_sample`, bilinear, padding "zeros" or "border"),
so here it is that call, in the JAX package's layout. Sampling runs in
float32 whatever the image's dtype: `F.grid_sample` wants the grid in the
image's dtype, and a bf16 grid cannot address a 1344-pixel image to the
pixel. The JAX function promotes a bf16 image to float32 the same way
(its bilinear weights are float32).

The backward is the port's own (`BilinearSample`). `F.grid_sample`'s CUDA
backward accumulates the image gradient with atomics, so two runs of a
training step differ in their last bits; the JAX package's gathers have
XLA's scatter-add as their VJP, which gives one answer every time. Here
the grid gradient gathers the four corners, and the image gradient sorts
its 4 x P destination pixels with a stable sort and sums each run of
equal destinations in that order (`ordered_index_add_`), in pieces of
BACKWARD_CHUNK_BYTES added one after the other. The result is the same
bits in every run, whatever `torch.use_deterministic_algorithms` says.
The forward is `F.grid_sample` itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

# bytes of the sorted (4 x points, C) rows the image gradient sums at once
BACKWARD_CHUNK_BYTES = 256 * 2**20


def safe_l2_normalize(x: torch.Tensor, dim: int = -1,
                      eps: float = 1e-12) -> torch.Tensor:
    """`x * rsqrt(sum(x^2) + eps)` along `dim`, the JAX package's form
    (finite at an exact zero vector), not `F.normalize`'s
    `x / max(||x||, eps)`."""
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


class OrderedSegments:
    """Sums of rows by destination whose result does not depend on the
    run, for one `index` used many times: the rows bound for one
    destination are summed in their order in `index` (a stable sort, then
    `torch.segment_reduce`). The sort and the destinations (one host read)
    are taken once, here. The CUDA `index_add_` adds with atomics, in any
    order."""

    def __init__(self, index: torch.Tensor):
        keys, self.order = torch.sort(index, stable=True)
        self.dest, self.counts = torch.unique_consecutive(
            keys, return_counts=True)

    def add_(self, acc: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """`acc.index_add_(0, index, values)` in index order; values of
        any rank (summed as rows of their flattened trailing dims)."""
        rows = values[self.order]
        sums = torch.segment_reduce(rows.reshape(len(rows), -1)
                                    if rows.dim() > 2 else rows, "sum",
                                    lengths=self.counts, axis=0, unsafe=True)
        acc[self.dest] = acc[self.dest] + sums.reshape(
            (len(self.dest),) + values.shape[1:])
        return acc


def ordered_index_add_(acc: torch.Tensor, index: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """`acc.index_add_(0, index, values)` whose result does not depend on
    the run: the rows bound for one destination are summed in their order
    in `index` (`OrderedSegments`), then added to `acc` once."""
    return OrderedSegments(index).add_(acc, values)


def _source_index(coord: torch.Tensor, size: int, align_corners: bool,
                  border: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """torch's grid-sampler source index (unnormalized; clipped to the
    image for border padding) and its derivative with respect to the
    normalized coordinate."""
    if align_corners:
        x, mult = (coord + 1) / 2 * (size - 1), (size - 1) / 2
    else:
        x, mult = ((coord + 1) * size - 1) / 2, size / 2
    if not border:
        return x, torch.full_like(x, mult)
    inside = (x > 0) & (x < size - 1)
    return x.clamp(0, size - 1), inside.to(x.dtype) * mult


def _piece_backward(image: torch.Tensor, pts: torch.Tensor, g: torch.Tensor,
                    align_corners: bool, border: bool,
                    grad_rows: torch.Tensor | None,
                    grad_pts: torch.Tensor | None) -> None:
    """One piece of p points: image (N, C, H, W), pts (N, p, 2), g (N, C, p)
    the output's gradient. Adds the image gradient into grad_rows
    (N * H * W, C) and writes the points' gradient into grad_pts (N, p,
    2)."""
    N, C, H, W = image.shape
    p = pts.shape[1]
    x, mx = _source_index(pts[..., 0], W, align_corners, border)
    y, my = _source_index(pts[..., 1], H, align_corners, border)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx0, wx1 = (x0 + 1) - x, x - x0
    wy0, wy1 = (y0 + 1) - y, y - y0
    idx, ok, wts = [], [], []          # corners nw, ne, sw, se
    for yy, xx, w in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                      (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        inside = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx.append(yy.clamp(0, H - 1).long() * W
                   + xx.clamp(0, W - 1).long())
        ok.append(inside)
        wts.append(torch.where(inside, w, 0.0))
    if grad_pts is not None:
        flat = image.reshape(N, C, H * W)
        s = [torch.where(o, (g * torch.gather(
            flat, 2, i[:, None].expand(N, C, p))).sum(1), 0.0)
             for i, o in zip(idx, ok)]                         # (N, p) each
        gx = (s[1] - s[0]) * wy0 + (s[3] - s[2]) * wy1
        gy = (s[2] - s[0]) * wx0 + (s[3] - s[1]) * wx1
        grad_pts.copy_(torch.stack([gx * mx, gy * my], -1))
    if grad_rows is not None:
        dev = image.device
        base = torch.arange(N, device=dev)[:, None] * (H * W)
        keys = torch.stack([i + base for i in idx], 1).reshape(-1)
        w = torch.stack(wts, 1).reshape(-1)                  # (N * 4 * p,)
        src = (torch.arange(N * p, device=dev).view(N, 1, p)
               .expand(N, 4, p).reshape(-1))
        rows = g.transpose(1, 2).reshape(N * p, C)[src] * w[:, None]
        ordered_index_add_(grad_rows, keys, rows)


def sample_backward(image: torch.Tensor, grid: torch.Tensor,
                    grad_out: torch.Tensor, align_corners: bool,
                    padding_mode: str, need_image: bool = True,
                    need_grid: bool = True):
    """Gradients of `F.grid_sample(image, grid)` (bilinear) with respect to
    image (N, C, H, W) and grid (N, Hg, Wg, 2), given the output's gradient
    grad_out (N, C, Hg, Wg); None for one not needed. The points go in
    pieces whose sorted rows fit BACKWARD_CHUNK_BYTES."""
    N, C, H, W = image.shape
    P = grid.shape[1] * grid.shape[2]
    pts = grid.reshape(N, P, 2)
    g = grad_out.reshape(N, C, P)
    border = padding_mode == "border"
    rows = (torch.zeros((N * H * W, C), dtype=image.dtype,
                        device=image.device) if need_image else None)
    gpts = torch.empty_like(pts) if need_grid else None
    piece = max(1, BACKWARD_CHUNK_BYTES // (4 * N * C * image.element_size()))
    for p0 in range(0, P, piece):
        sl = slice(p0, p0 + piece)
        _piece_backward(image, pts[:, sl], g[:, :, sl], align_corners,
                        border, rows, None if gpts is None else gpts[:, sl])
    gi = (None if rows is None
          else rows.view(N, H, W, C).permute(0, 3, 1, 2).contiguous())
    return gi, None if gpts is None else gpts.view_as(grid)


class BilinearSample(torch.autograd.Function):
    """`F.grid_sample(image, grid, mode="bilinear")` whose backward gives
    the same bits in every run (`sample_backward`). image (N, C, H, W),
    grid (N, Hg, Wg, 2), of one dtype."""

    @staticmethod
    def forward(ctx, image, grid, align_corners: bool, padding_mode: str):
        ctx.save_for_backward(image, grid)
        ctx.opts = (align_corners, padding_mode)
        return F.grid_sample(image, grid, mode="bilinear",
                             padding_mode=padding_mode,
                             align_corners=align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        image, grid = ctx.saved_tensors
        gi, gg = sample_backward(image, grid, grad_out, *ctx.opts,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        return gi, gg, None, None


def bilinear_sample(image: torch.Tensor, grid: torch.Tensor, *,
                    align_corners: bool = False,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """`F.grid_sample` (bilinear; image (N, C, H, W), grid (N, Hg, Wg, 2))
    through `BilinearSample`."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    return BilinearSample.apply(image, grid, align_corners, padding_mode)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *,
                align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample `image` (..., C, H, W) at `grid` (..., P, 2), xy in
    [-1, 1] (align_corners=False is the reference convention). The
    leading dims of both are equal. Returns (..., C, P) in float32."""
    C, H, W = image.shape[-3:]
    lead = image.shape[:-3]
    P = grid.shape[-2]
    img = image.reshape(-1, C, H, W).float()
    g = grid.reshape(-1, 1, P, 2).float()
    out = bilinear_sample(img, g, padding_mode=padding_mode,
                          align_corners=align_corners)       # (N, C, 1, P)
    return out.reshape(*lead, C, P)


def sample_descriptors(kpts: torch.Tensor, descriptors: torch.Tensor,
                       s: int = 8, legacy: bool = False) -> torch.Tensor:
    """SuperPoint's descriptors at keypoints (`gim_tpu/ops/sampling.py:
    99-127`). kpts: (B, K, 2) xy in full-resolution pixels; descriptors:
    (B, C, Hc, Wc) at stride `s`. Returns (B, K, C), L2-normalized.

    legacy=True is the reference's normalization that its weights were
    trained with (ref superpoint.py:117-134): (kpts - s/2 + 0.5) divided
    by s * size - s/2 - 0.5, align_corners=True. legacy=False is the
    fixed half-pixel grid (ref superpoint.py:139-150), align_corners=False.
    The divisors are Python numbers: a tensor made from them on the card
    would be a host-to-device copy that waits for the stream."""
    C, Hc, Wc = descriptors.shape[-3:]
    if legacy:
        x = kpts - s / 2 + 0.5
        div = (Wc * s - s / 2 - 0.5, Hc * s - s / 2 - 0.5)
    else:
        x, div = kpts, (Wc * s, Hc * s)
    g = torch.stack([x[..., 0] / div[0], x[..., 1] / div[1]], -1) * 2 - 1
    out = grid_sample(descriptors, g, align_corners=legacy)
    return safe_l2_normalize(out.transpose(-1, -2), dim=-1)
