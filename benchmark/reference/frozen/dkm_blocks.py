"""DKM building blocks, shared by gim_dkm and gim_roma (PyTorch port).

Port of `gim_tpu/models/dkm/blocks.py`: `coords_grid` (:34-41),
`resize_nhwc` (:44-52; its backward the port's own,
`ops/resize.BilinearResize`),
`resize_region_nhwc` (:55-79), `sample_nhwc`
(:82-92), `local_correlation` (:147-301), `kde_density` (:304-328),
`CosKernel` (:331-347), `GP` (:405-459, with `bug_compat`), `RRB`
(:462-480), `CAB` (:483-497), `DFNScale` (:500-527, here the scales of
one `DFN`) and `ConvRefiner` (:530-680, both variants); reference:
networks/dkm/models/dkm.py, networks/roma/roma.py:436-580.

Layouts: flows (B, H, W, 2) and certainties (B, H, W, 1) are NHWC, as
in the JAX package and as grids for `F.grid_sample`; so are the resizes
and `GP`. Feature maps are PyTorch's NCHW: `local_correlation`, `RRB`,
`CAB`, `DFN` and `ConvRefiner` take them (B, C, H, W).

The JAX package writes some of this math twice, a TPU layout beside the
plain one (packed warps and correlation rows, Cholesky and CG solves);
the port writes each once.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.frozen.common import batchnorm, conv
from benchmark.reference.frozen.resize import resize_bilinear
from benchmark.reference.frozen.sampling import bilinear_sample, grid_sample
from benchmark.reference.frozen.device import torch_dtype


def coords_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """(b, h, w, 2) normalized pixel-centre xy grid (linspace -1+1/h ..
    1-1/h), float32."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device=device)
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(b, h, w, 2)


def resize_nhwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`resize_bilinear` of (B, H, W, C)."""
    return resize_bilinear(x.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)


def sample_nhwc(img: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """grid_sample in NHWC: img (B, H, W, C), coords (B, ..., 2) in
    [-1, 1] -> (B, ..., C) float32, align_corners=False."""
    B, _, _, C = img.shape
    lead = coords.shape[1:-1]
    out = grid_sample(img.permute(0, 3, 1, 2), coords.reshape(B, -1, 2),
                      padding_mode=padding_mode)             # (B, C, P)
    return out.transpose(1, 2).reshape(B, *lead, C)


def resize_region_nhwc(x: torch.Tensor, h: int, w: int,
                       extent01: torch.Tensor) -> torch.Tensor:
    """Bilinear-resize the top-left (w_frac, h_frac) = extent01 (B, 2) part
    of each canvas x (B, H, W, C) to (h, w): the reference eval's aspect-
    distorting resize of the valid rectangle, with static shapes."""
    B, H, W, _ = x.shape
    dev = x.device
    ys = (torch.arange(h, device=dev) + 0.5) / h
    xs = (torch.arange(w, device=dev) + 0.5) / w
    src_y = ys[None, :] * (extent01[:, 1:2] * H) - 0.5           # (B, h)
    src_x = xs[None, :] * (extent01[:, 0:1] * W) - 0.5           # (B, w)
    ny = (2.0 * src_y + 1.0) / H - 1.0
    nx = (2.0 * src_x + 1.0) / W - 1.0
    coords = torch.stack([nx[:, None, :].expand(B, h, w),
                          ny[:, :, None].expand(B, h, w)], dim=-1)
    return sample_nhwc(x, coords, padding_mode="border")


CORR_CHUNK_BYTES = 512 * 2**20   # float32 samples per grid_sample call


def local_correlation(x: torch.Tensor, y: torch.Tensor, radius: int,
                      flow: torch.Tensor | None = None) -> torch.Tensor:
    """(2r+1)^2 window correlation (ref local_correlation.py:5-41).

    x, y: (B, C, H, W); flow: (B, H, W, 2) normalized window centres in y
    (the identity grid if None). Returns (B, (2r+1)^2, H, W) in x's dtype,
    windows dy-major, each <x, bilinear y> / sqrt(C) with zeros outside y.
    The window offsets are whole pixels; the samples of several offsets
    are taken by one `F.grid_sample` (offsets stacked on the grid's rows),
    as many as fit CORR_CHUNK_BYTES, through `ops.sampling.bilinear_sample`,
    whose backward gives the same bits in every run.
    """
    B, C, H, W = x.shape
    r = radius
    K = 2 * r + 1
    if flow is None:
        flow = coords_grid(B, H, W, x.device)
    xf = x.float()
    yf = y.float()
    flow = flow.float()
    dev = x.device
    dy, dx = torch.meshgrid(torch.arange(-r, r + 1, device=dev),
                            torch.arange(-r, r + 1, device=dev),
                            indexing="ij")
    offs = torch.stack([2.0 * dx.reshape(-1) / W, 2.0 * dy.reshape(-1) / H],
                       dim=-1)                                # (K^2, 2) xy
    chunk = max(1, min(K * K, CORR_CHUNK_BYTES // (4 * B * C * H * W)))
    scale = 1.0 / math.sqrt(C)
    out = torch.empty((B, K * K, H, W), dtype=torch.float32, device=dev)
    for k0 in range(0, K * K, chunk):
        o = offs[k0:k0 + chunk]                               # (n, 2)
        n = o.shape[0]
        grid = (flow[:, None] + o[None, :, None, None]).reshape(
            B, n * H, W, 2)
        s = bilinear_sample(yf, grid).view(B, C, n, H, W)
        out[:, k0:k0 + n] = (s * xf[:, :, None]).sum(1) * scale
    return out.to(x.dtype)


def kde_density(x: torch.Tensor, std: float = 0.1,
                chunk: int = 4096) -> torch.Tensor:
    """Gaussian KDE over row vectors (ref utils/kde.py:17-24). x: (N, D).
    Rows are taken `chunk` at a time, so (chunk, N) is the largest
    temporary."""
    inv = 1.0 / (2 * std * std)
    sq = (x * x).sum(-1)
    out = []
    for i in range(0, x.shape[0], chunk):
        d2 = sq[i:i + chunk, None] + sq[None, :] - 2.0 * (x[i:i + chunk]
                                                          @ x.T)
        out.append(torch.exp(-d2.clamp_min(0.0) * inv).sum(-1))
    return torch.cat(out)


class CosKernel:
    """exp((cos_sim - 1) / T) (ref dkm.py:126-144, learn_temperature off)."""

    def __init__(self, T: float = 0.2):
        self.T = T

    def __call__(self, x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6):
        nx = torch.sqrt((x * x).sum(-1) + 1e-24)
        ny = torch.sqrt((y * y).sum(-1) + 1e-24)
        c = (x @ y.transpose(1, 2)) / (nx[..., None] * ny[:, None] + eps)
        return torch.exp((c - 1.0) / self.T)


class GP(nn.Module):
    """Cosine-kernel GP regression of fourier position embeddings (ref
    dkm.py:257-370, no_cov=True, basis='fourier'). float32 throughout; the
    callers turn TF32 off, so every product is full float32.

    `bug_compat` reproduces the reference's batched inverse for n >
    `bug_compat_min_n` (ref dkm.py:355-359; `gim_tpu/models/dkm/
    blocks.py:412-425`): with more than one row, only row 0's K_yy is
    solved and K_xy @ K_yy^-1 f broadcasts that solution to every row.
    gim_dkm's eval graph turns it on (`DKMConfig.gp_inv_bug_compat`); at
    660 x 880 its scale 16 has n = 42 x 55 = 2310."""

    def __init__(self, gp_dim: int = 256, T: float = 0.2,
                 sigma_noise: float = 0.1, bug_compat: bool = False,
                 bug_compat_min_n: int = 2000):
        super().__init__()
        self.gp_dim = gp_dim
        self.T = T
        self.sigma_noise = sigma_noise
        self.bug_compat = bug_compat
        self.bug_compat_min_n = bug_compat_min_n
        self.pos_conv = nn.Conv2d(2, gp_dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (B, H, W, C) projected features. Returns (B, H, W,
        gp_dim) float32."""
        x = x.float()
        y = y.float()
        B, H, W, C = y.shape
        coords = coords_grid(B, H, W, y.device)
        f = torch.cos(8 * math.pi * F.linear(
            coords, self.pos_conv.weight[:, :, 0, 0], self.pos_conv.bias))
        K = CosKernel(self.T)
        xf = x.reshape(B, -1, C)
        yf = y.reshape(B, -1, C)
        ff = f.reshape(B, -1, self.gp_dim)
        K_xy = K(xf, yf)
        K_yy = K(yf, yf)
        n = K_yy.shape[-1]
        rows = 1 if self.bug_compat and n > self.bug_compat_min_n else B
        A = K_yy[:rows] + self.sigma_noise * torch.eye(n, device=y.device)
        # one LU solve per image: on CUDA a batched call goes to MAGMA's
        # batched routines, which are meant for small matrices
        sol = torch.stack([torch.linalg.solve(A[b], ff[b])
                           for b in range(rows)])
        mu = K_xy @ sol                   # (rows, n, d) broadcasts to B
        return mu.reshape(B, x.shape[1], x.shape[2], self.gp_dim)


class RRB(nn.Module):
    """Refinement residual block (ref dkm.py:173-202): 1x1 conv, then
    relu(x + conv3(relu(bn(conv2(x))))) with 3x3 convs; the BatchNorm
    takes the batch's statistics in `train_mode`."""

    def __init__(self, in_dim: int, out_dim: int, dtype: str = "float32",
                 train_mode: bool = False):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.train_mode = train_mode
        self.conv1 = nn.Conv2d(in_dim, out_dim, 1)
        self.conv2 = nn.Conv2d(out_dim, out_dim, 3, padding=1)
        self.bn = nn.BatchNorm2d(out_dim)
        self.conv3 = nn.Conv2d(out_dim, out_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = conv(self.conv1, x, dt)
        res = F.relu(batchnorm(self.bn, conv(self.conv2, x, dt), dt,
                               self.train_mode))
        return F.relu(x + conv(self.conv3, res, dt))


class CAB(nn.Module):
    """Channel attention over the pair [x1, x2] (ref dkm.py:147-170):
    g = sigmoid(conv2(relu(conv1(mean_hw [x1; x2])))), out g * x2 + x1."""

    def __init__(self, in_dim: int, out_dim: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.conv1 = nn.Conv2d(in_dim, out_dim, 1)
        self.conv2 = nn.Conv2d(out_dim, out_dim, 1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        g = torch.cat([x1, x2], dim=1).mean((2, 3), keepdim=True)
        g = F.relu(conv(self.conv1, g, dt))
        g = torch.sigmoid(conv(self.conv2, g, dt))
        return g * x2 + x1


class DFN(nn.Module):
    """DKM's embedding decoder (ref dkm.py:205-254, DKMv3.py:9-47): one
    `DFNScale` (`gim_tpu/models/dkm/blocks.py:500-527`) per scale, its
    modules held in per-scale dicts as the reference's state dict keys
    them (`feat_input_modules.{s}`, `rrb_d.{s}`, `cab.{s}`, `rrb_u.{s}`,
    `terminal_module.{s}`). `train_mode` reaches the RRBs' BatchNorms."""

    def __init__(self, scales=("32", "16"), in_dim: int = 512,
                 feat_dim: int = 256, gp_dim: int = 256,
                 internal_dim: int = 384, dtype: str = "float32",
                 train_mode: bool = False):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.feat_input_modules = nn.ModuleDict({
            s: nn.Conv2d(in_dim, feat_dim, 1) for s in scales})
        self.rrb_d = nn.ModuleDict({
            s: RRB(feat_dim + gp_dim, internal_dim, dtype, train_mode)
            for s in scales})
        self.cab = nn.ModuleDict({
            s: CAB(2 * internal_dim, internal_dim, dtype) for s in scales})
        self.rrb_u = nn.ModuleDict({
            s: RRB(internal_dim, internal_dim, dtype, train_mode)
            for s in scales})
        self.terminal_module = nn.ModuleDict({
            s: nn.Conv2d(internal_dim, 3, 1) for s in scales})

    def forward(self, s: str, embeddings: torch.Tensor, feats: torch.Tensor,
                context: torch.Tensor):
        """Scale `s`: embeddings (B, H, W, gp_dim) the GP posterior; feats
        (B, C, H, W); context (B, internal_dim, H, W). Returns float32 flow
        (B, H, W, 2) and certainty (B, H, W, 1), and the new context."""
        dt = self.dtype
        feats = conv(self.feat_input_modules[s], feats, dt)
        emb = torch.cat([feats, embeddings.permute(0, 3, 1, 2).to(dt)], dim=1)
        emb = self.rrb_d[s](emb)
        context = self.rrb_u[s](self.cab[s](context.to(dt), emb))
        preds = conv(self.terminal_module[s], context, dt).float().permute(
            0, 2, 3, 1)
        return preds[..., -2:], preds[..., :-2], context


def _block(in_dim: int, out_dim: int) -> nn.Sequential:
    """Reference layout of a refiner block (ref dkm.py:27-47): depthwise
    5x5 conv (0), BatchNorm (1), ReLU (2), 1x1 conv (3)."""
    return nn.Sequential(
        nn.Conv2d(in_dim, out_dim, 5, padding=2, groups=in_dim),
        nn.BatchNorm2d(out_dim), nn.ReLU(), nn.Conv2d(out_dim, out_dim, 1))


def _run_block(block: nn.Sequential, x: torch.Tensor, dt: torch.dtype,
               train: bool = False) -> torch.Tensor:
    h = batchnorm(block[1], conv(block[0], x, dt), dt, train)
    return conv(block[3], F.relu(h), dt)


class ConvRefiner(nn.Module):
    """Depthwise conv refiner of DKM and RoMa (ref dkm.py:11-123,
    roma.py:436-580): the features, the other image's features warped by
    the flow, a 1x1 embedding of emb_scale * (flow - grid) and, with a
    radius, the local correlation in the other image around the flow;
    then `block1` (a grouped 5x5 conv in_dim -> hidden_dim: at DKM's scale
    1, 12 -> 24, two output channels per group), 8 hidden blocks of 5x5
    depthwise convolutions and out_conv. DKM's out_conv gives [certainty,
    dx, dy] and RoMa's [dx, dy, certainty] (`disp_first`); RoMa passes
    emb_scale 40/32 * scale_factor, DKM 1.

    The benchmark's frozen copy runs every block as depthwise conv,
    BatchNorm, ReLU and 1x1 conv, the JAX default graph.
    """

    def __init__(self, in_dim: int, hidden_dim: int,
                 displacement_emb_dim: int,
                 local_corr_radius: int | None = None,
                 disp_first: bool = False, dtype: str = "float32",
                 train_mode: bool = False):
        super().__init__()
        self.train_mode = train_mode
        self.hidden_dim = hidden_dim
        self.local_corr_radius = local_corr_radius
        self.disp_first = disp_first
        self.dtype = torch_dtype(dtype)
        self.block1 = _block(in_dim, hidden_dim)
        self.hidden_blocks = nn.Sequential(*[
            _block(hidden_dim, hidden_dim) for _ in range(8)])
        self.out_conv = nn.Conv2d(hidden_dim, 3, 1)
        self.disp_emb = nn.Conv2d(2, displacement_emb_dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, flow: torch.Tensor,
                emb_scale: float = 1.0):
        """x, y: (B, C, H, W); flow: (B, H, W, 2). Returns (certainty
        (B, H, W, 1), displacement (B, H, W, 2)), float32."""
        dt = self.dtype
        x = x.to(dt)
        y = y.to(dt)
        flow = flow.float()
        B, C, H, W = x.shape
        x_hat = grid_sample(y, flow.reshape(B, H * W, 2)).view(
            B, C, H, W).detach()
        disp = (flow - coords_grid(B, H, W, x.device)).permute(0, 3, 1, 2)
        parts = [x, x_hat, conv(self.disp_emb, emb_scale * disp,
                                torch.float32)]
        if self.local_corr_radius:
            parts.append(local_correlation(x, y, self.local_corr_radius,
                                           flow=flow))
        d = torch.cat([p.to(dt) for p in parts], dim=1)
        d = _run_block(self.block1, d, dt, self.train_mode)
        for blk in self.hidden_blocks:
            d = _run_block(blk, d, dt, self.train_mode)
        d = conv(self.out_conv, d, dt).float().permute(0, 2, 3, 1)
        if self.disp_first:
            return d[..., -1:], d[..., :-1]
        return d[..., :-2], d[..., -2:]
