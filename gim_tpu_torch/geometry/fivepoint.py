"""Batched 5-point (Nister) minimal essential-matrix solver (port of
`gim_tpu/geometry/fivepoint.py`).

Same algorithm and float32 arithmetic as the JAX package, batched over
any leading sample dims with no loop over samples:

1. nullspace of the 5x9 epipolar constraint matrix by a hand-unrolled
   Householder QR -> 4 basis matrices, E = x*E0 + y*E1 + z*E2 + E3;
2. det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0 expanded over the
   20-monomial basis of degree <= 3 with constant one-hot multiplication
   tables -> a (10, 20) coefficient system;
3. Gauss-Jordan with partial pivoting (10 static steps, row swaps as
   elementwise updates), then Nister's z-elimination -> the 3x3
   polynomial matrix B(z) and its degree-10 determinant;
4. real roots by a global search: z = tan(theta), the homogenized
   polynomial on a uniform theta grid of 1025 points, the first 10 sign
   changes bracketed, 30 bisection steps, 3 Newton steps;
5. (x, y) per root by 2x2 least squares on B(z)'s rows.

Each sample yields up to 10 candidate essential matrices with a validity
mask. The tables are module-load numpy constants, as in the JAX package,
copied to each device once.
"""

from __future__ import annotations

import numpy as np
import torch

from gim_tpu_torch.utils.device import device_constant
from gim_tpu_torch.utils.precision import highp

# degree <= 1 basis: x, y, z, 1
_MONO1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# degree <= 2 basis
_MONO2 = [(2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1),
          (0, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# degree <= 3 basis, Nister-ordered: the first 10 monomials have
# deg_x + deg_y >= 2 (eliminated by Gauss-Jordan); the trailing 10 are
# x*(z^2,z,1), y*(z^2,z,1), (z^3,z^2,z,1).
_MONO3 = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
          (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
          (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
          (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]


def _mul_table(a_basis, b_basis, out_basis):
    out_index = {m: i for i, m in enumerate(out_basis)}
    t = np.zeros((len(a_basis), len(b_basis), len(out_basis)), np.float32)
    for i, ma in enumerate(a_basis):
        for j, mb in enumerate(b_basis):
            m = tuple(ea + eb for ea, eb in zip(ma, mb))
            t[i, j, out_index[m]] = 1.0
    return t


_T11 = _mul_table(_MONO1, _MONO1, _MONO2)   # (4, 4, 10)
_T21 = _mul_table(_MONO2, _MONO1, _MONO3)   # (10, 4, 20)


def _pconv_tensor(la: int, lb: int) -> np.ndarray:
    t = np.zeros((la, lb, la + lb - 1), np.float32)
    for i in range(la):
        for j in range(lb):
            t[i, j, i + j] = 1.0
    return t


# the root search's theta grid, bit for bit as jnp.linspace(-pi/2 + eps,
# pi/2 - eps, 1025) computes it: start*(1 - s) rounded, then one fused
# multiply-add with stop*s
_EPS = 1e-4
_GRID = 1024


def _theta_grid(grid: int) -> np.ndarray:
    start = np.float32(-np.pi / 2 + _EPS)
    stop = np.float32(np.pi / 2 - _EPS)
    s = np.arange(grid, dtype=np.float32) / np.float32(grid)
    head = (np.float64(start * (np.float32(1) - s))
            + np.float64(stop) * s).astype(np.float32)
    return np.concatenate([head, [stop]]).astype(np.float32)


_THETA = _theta_grid(_GRID)


def _table_product(a, b, name, table):
    """(..., i) x (..., j) through a one-hot (i, j, k) table -> (..., k)."""
    t = device_constant(name, table, a.device)
    outer = a[..., :, None] * b[..., None, :]
    return outer.flatten(-2) @ t.reshape(-1, t.shape[-1])


def _mul11(a, b):
    """(..., 4) x (..., 4) -> (..., 10)."""
    return _table_product(a, b, "fivepoint.T11", _T11)


def _mul21(a, b):
    """(..., 10) x (..., 4) -> (..., 20)."""
    return _table_product(a, b, "fivepoint.T21", _T21)


def pconv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product on trailing coefficient axes (highest degree
    first). (..., la) x (..., lb) -> (..., la+lb-1)."""
    la, lb = a.shape[-1], b.shape[-1]
    return _table_product(a, b, f"fivepoint.conv{la}x{lb}",
                          _pconv_tensor(la, lb))


# ---------------------------------------------------------------------------
# Steps 1-2: nullspace basis and the 10x20 constraint system
# ---------------------------------------------------------------------------

def _epipolar_rows9(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Rows of p1^T E p0 = 0 for E flattened row-major.
    p0/p1: (..., N, 2) -> (..., N, 9)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    one = torch.ones_like(x0)
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                        x0, y0, one], dim=-1)


@highp
def nullspace_basis(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """4-dim nullspace of the 5x9 constraint matrix.
    p0/p1: (..., 5, 2) -> (..., 4, 3, 3) basis matrices (E0, E1, E2, E3).

    Hand-unrolled batched Householder QR of A^T (9x5): Q's last 4 columns
    span null(A); five reflections of broadcast-reduce vector ops."""
    a = _epipolar_rows9(p0, p1)                       # (..., 5, 9)
    R = a.transpose(-1, -2)                           # (..., 9, 5)
    batch = R.shape[:-2]
    Q = torch.eye(9, dtype=R.dtype, device=R.device).expand(*batch, 9, 9)
    rows = torch.arange(9, device=R.device)
    for k in range(5):
        x = torch.where(rows >= k, R[..., :, k], 0.0)  # (..., 9)
        sigma = (x * x).sum(-1).sqrt()
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0)
        alpha = -sign * sigma
        v = x - torch.where(rows == k, alpha[..., None], 0.0)
        vn2 = (v * v).sum(-1, keepdim=True)
        # skip the reflection on (near-)zero columns: H = I
        inv = torch.where(vn2 > 1e-30, 2.0 / vn2.clamp_min(1e-30), 0.0)
        vtR = (v[..., :, None] * R).sum(-2)           # (..., 5)
        R = R - (inv * v)[..., :, None] * vtR[..., None, :]
        Qv = (Q * v[..., None, :]).sum(-1)            # (..., 9)
        Q = Q - (inv * Qv)[..., :, None] * v[..., None, :]
    basis = Q[..., :, 5:].transpose(-1, -2)           # (..., 4, 9)
    return basis.reshape(*basis.shape[:-1], 3, 3)


@highp
def constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints (det E = 0 and the trace constraint) as a
    (..., 10, 20) coefficient matrix over _MONO3."""
    e = basis.movedim(-3, -1)                         # (..., 3, 3, 4)

    def m11(i, j, k, l):
        return _mul11(e[..., i, j, :], e[..., k, l, :])

    # det(E) (degree 3, 20 coeffs)
    c00 = m11(1, 1, 2, 2) - m11(1, 2, 2, 1)
    c01 = m11(1, 0, 2, 2) - m11(1, 2, 2, 0)
    c02 = m11(1, 0, 2, 1) - m11(1, 1, 2, 0)
    det = (_mul21(c00, e[..., 0, 0, :]) - _mul21(c01, e[..., 0, 1, :])
           + _mul21(c02, e[..., 0, 2, :]))

    # EE^T entries (degree 2): (..., 3, 3, 10)
    eet = torch.stack([
        torch.stack([sum(m11(i, k, j, k) for k in range(3))
                     for j in range(3)], dim=-2)
        for i in range(3)], dim=-3)
    tr = eet[..., 0, 0, :] + eet[..., 1, 1, :] + eet[..., 2, 2, :]

    rows = [det]
    for i in range(3):
        for j in range(3):
            cij = sum(_mul21(2.0 * eet[..., i, k, :], e[..., k, j, :])
                      for k in range(3))
            rows.append(cij - _mul21(tr, e[..., i, j, :]))
    return torch.stack(rows, dim=-2)                  # (..., 10, 20)


# ---------------------------------------------------------------------------
# Step 3: Gauss-Jordan + Nister z-elimination
# ---------------------------------------------------------------------------

@highp
def gauss_jordan(a: torch.Tensor) -> torch.Tensor:
    """Reduce (..., 10, 20) to [I | M] with partial pivoting (10 static
    steps, batched; row swaps as two rank-1 elementwise updates)."""
    n = a.shape[-2]
    rows_idx = torch.arange(n, device=a.device)
    for k in range(n):
        col = torch.where(rows_idx >= k, a[..., :, k].abs(), -1.0)
        piv = col.argmax(-1)                          # (...,) first maximum
        pk = (rows_idx == piv[..., None]).to(a.dtype)  # (..., n)
        ek = (rows_idx == k).to(a.dtype)
        row_piv = (pk[..., :, None] * a).sum(-2)      # (..., 20)
        row_kv = a[..., k, :]
        a = (a + ek[:, None] * (row_piv - row_kv)[..., None, :]
             + pk[..., :, None] * (row_kv - row_piv)[..., None, :])
        pivval = a[..., k:k + 1, k:k + 1]
        safe = torch.where(pivval.abs() < 1e-12,
                           torch.where(pivval < 0, -1e-12, 1e-12), pivval)
        row_k = a[..., k:k + 1, :] / safe
        factors = a[..., :, k:k + 1]                  # (..., n, 1)
        mask = (rows_idx != k).to(a.dtype)[:, None]
        a = a - mask * factors * row_k
        a = torch.where((rows_idx == k)[:, None], row_k, a)
    return a


@highp
def detb_coeffs(reduced: torch.Tensor):
    """From the reduced system, B(z) (Nister's 3x3 polynomial matrix) and
    its determinant's degree-10 coefficients.

    Returns (c (..., 11) highest-first, (bx (..., 3, 4), by (..., 3, 4),
    b1 (..., 3, 5)))."""
    m = reduced[..., :, 10:]                          # (..., 10, 10)

    def eq(r, s):
        # row r leads mu*z, row s leads mu: eq = m_r - z * m_s
        px = torch.stack([-m[..., s, 0], m[..., r, 0] - m[..., s, 1],
                          m[..., r, 1] - m[..., s, 2], m[..., r, 2]], dim=-1)
        py = torch.stack([-m[..., s, 3], m[..., r, 3] - m[..., s, 4],
                          m[..., r, 4] - m[..., s, 5], m[..., r, 5]], dim=-1)
        p1 = torch.stack([-m[..., s, 6], m[..., r, 6] - m[..., s, 7],
                          m[..., r, 7] - m[..., s, 8],
                          m[..., r, 8] - m[..., s, 9], m[..., r, 9]], dim=-1)
        return px, py, p1

    # leading monomials (by _MONO3 order): row4 = x^2 z, row5 = x^2,
    # row6 = y^2 z, row7 = y^2, row8 = xyz, row9 = xy
    ax, ay, a1 = eq(4, 5)
    bx, by, b1 = eq(6, 7)
    cx, cy, c1 = eq(8, 9)

    # det B = ax (by c1 - b1 cy) - ay (bx c1 - b1 cx) + a1 (bx cy - by cx)
    t1 = pconv(by, c1) - pconv(b1, cy)                # (..., 8)
    t2 = pconv(bx, c1) - pconv(b1, cx)
    t3 = pconv(bx, cy) - pconv(by, cx)                # (..., 7)
    det = pconv(ax, t1) - pconv(ay, t2) + pconv(a1, t3)   # (..., 11)
    return det, (torch.stack([ax, bx, cx], dim=-2),
                 torch.stack([ay, by, cy], dim=-2),
                 torch.stack([a1, b1, c1], dim=-2))


# ---------------------------------------------------------------------------
# Step 4: degree-10 roots
# ---------------------------------------------------------------------------

def _horner(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial (coeffs (..., n) highest first) at x (..., R)."""
    out = c[..., 0:1].expand(x.shape)
    for i in range(1, c.shape[-1]):
        out = out * x + c[..., i:i + 1]
    return out


def _homog_eval(c: torch.Tensor, s: torch.Tensor,
                co: torch.Tensor) -> torch.Tensor:
    """q = sum_k c_k s^(n-k) co^k (= p(s/co) co^n), overflow-free for any
    root magnitude. c: (..., n+1) highest-first; s/co: (..., R)."""
    n = c.shape[-1] - 1
    cpow = torch.ones_like(co)
    q = c[..., 0:1] * torch.ones_like(s)
    for k in range(1, n + 1):
        cpow = cpow * co
        q = q * s + c[..., k:k + 1] * cpow
    return q


@highp
def roots_deg10(c: torch.Tensor, bisect_iters: int = 30,
                newton_iters: int = 3):
    """Real roots of batched degree-10 polynomials.

    z = tan(theta) maps the real line to theta in (-pi/2, pi/2); the
    homogenized polynomial is evaluated on the 1025-point theta grid, up
    to 10 sign changes are bracketed (first by grid position), bisected
    and Newton-polished. c: (..., 11) highest-first. Returns (roots
    (..., 10), valid (..., 10)); even-multiplicity roots (no sign change)
    are not found, as in the JAX package."""
    scale = c.abs().amax(-1, keepdim=True)
    cm = c / scale.clamp_min(1e-30)

    theta = device_constant("fivepoint.theta", _THETA, c.device)
    grid = theta.shape[0] - 1
    batch = cm.shape[:-1]
    s = torch.sin(theta).expand(*batch, grid + 1)
    co = torch.cos(theta).expand(*batch, grid + 1)
    q = _homog_eval(cm, s, co)
    sgn = torch.where(q >= 0, 1.0, -1.0)
    crossing = sgn[..., :-1] * sgn[..., 1:] < 0        # (..., grid)

    # up to 10 bracket indices: the scores are distinct (crossing first,
    # then by grid position), so top-k has no ties to order
    pos = torch.arange(grid, dtype=torch.float32, device=c.device)
    score = crossing.float() * 2.0 - pos / grid
    idx = score.topk(10, dim=-1).indices               # (..., 10)
    valid = crossing.gather(-1, idx)

    lo = theta[:-1].expand(*batch, grid).gather(-1, idx)
    hi = lo + (theta[1] - theta[0])
    slo = torch.where(q[..., :-1].gather(-1, idx) >= 0, 1.0, -1.0)

    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        qm = _homog_eval(cm, torch.sin(mid), torch.cos(mid))
        same = torch.where(qm >= 0, 1.0, -1.0) == slo
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    r = torch.tan(0.5 * (lo + hi))

    # Newton polish in z (guarded; steps clipped to 1)
    dc = cm[..., :-1] * torch.arange(10, 0, -1, device=c.device)
    for _ in range(newton_iters):
        pr = _horner(cm, r)
        dpr = _horner(dc, r)
        dpr = torch.where(dpr.abs() < 1e-20,
                          torch.where(dpr < 0, -1e-20, 1e-20), dpr)
        r = r - (pr / dpr).clamp(-1.0, 1.0)
    return r, valid & torch.isfinite(r)


# ---------------------------------------------------------------------------
# Step 5: back-substitution -> candidate essential matrices
# ---------------------------------------------------------------------------

def _horner_last(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """c: (..., 3, n) highest-first; x: (..., R, 1) -> (..., R, 3)."""
    out = c[..., None, :, 0].expand(*x.shape[:-1], 3)
    for i in range(1, c.shape[-1]):
        out = out * x + c[..., None, :, i]
    return out


@highp
def essential_candidates(p0: torch.Tensor, p1: torch.Tensor):
    """5-point minimal solve. p0/p1: (..., 5, 2) normalized camera coords.
    Returns (E (..., 10, 3, 3), valid (..., 10))."""
    basis = nullspace_basis(p0, p1)                   # (..., 4, 3, 3)
    reduced = gauss_jordan(constraint_matrix(basis))  # (..., 10, 20)
    det, (bxs, bys, b1s) = detb_coeffs(reduced)
    roots, rvalid = roots_deg10(det)                  # (..., 10)

    # B(z) rows at each root: (..., 10 roots, 3 rows)
    z = roots[..., :, None]
    B = torch.stack([_horner_last(bxs, z), _horner_last(bys, z),
                     _horner_last(b1s, z)], dim=-1)   # (..., 10, 3, 3)

    # (x, y) by least squares on the 3x2 system [Bx By][x y]^T = -B1,
    # rows scale-normalized first
    rn = torch.linalg.vector_norm(B, dim=-1, keepdim=True)
    Bn = B / rn.clamp_min(1e-20)
    A2 = Bn[..., :, :2]                               # (..., 10, 3, 2)
    rhs = -Bn[..., :, 2]                              # (..., 10, 3)
    ata = A2.transpose(-1, -2) @ A2                   # (..., 10, 2, 2)
    atb = (A2 * rhs[..., None]).sum(-2)               # (..., 10, 2)
    a, b2, d = ata[..., 0, 0], ata[..., 0, 1], ata[..., 1, 1]
    detn = a * d - b2 * b2
    dsafe = torch.where(detn.abs() < 1e-20,
                        torch.where(detn < 0, -1e-20, 1e-20), detn)
    x = (d * atb[..., 0] - b2 * atb[..., 1]) / dsafe
    y = (a * atb[..., 1] - b2 * atb[..., 0]) / dsafe
    valid = rvalid & (detn.abs() > 1e-12)

    # E = x E0 + y E1 + z E2 + E3
    coef = torch.stack([x, y, roots, torch.ones_like(x)], dim=-1)
    E = (coef[..., :, :, None] * basis.flatten(-2)[..., None, :, :]).sum(-2)
    nrm = torch.linalg.vector_norm(E, dim=-1)
    E = (E / nrm.clamp_min(1e-12)[..., None]).unflatten(-1, (3, 3))
    valid = valid & torch.isfinite(E).all(-1).all(-1) & (nrm > 1e-9)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    return torch.where(valid[..., None, None], E, eye), valid
