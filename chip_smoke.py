#!/usr/bin/env python3
"""Drive gim_tpu_torch's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, `nvcc`
(sm_90a) and PyTorch built for CUDA. Phases, each printing what it found:

1. environment: card name and power limit, torch / CUDA versions, TF32;
2. build: every kernel of the path, from the sources in the checkout;
3. kernel K1 (dsmax_stats, dsmax_argmax) against its plain PyTorch
   version at main-path shapes (8 pairs, L = S = 10816 coarse cells of
   832 px, C = 256, bf16; unmasked, masked, well separated), on a ragged
   float32 case and on ragged bf16 cases through the wgmma path
   ((2, 1000, 1300, 256); (1, 70, 90, 32); one partial f0 block against
   S = 10816, masked), with timings of kernel, plain version and
   `torch.bmm` of the same f0 f1^T, beside the card's bound (products,
   exp2s and bytes, whichever is largest);
4. main path: `Matcher("gim_loftr")` at full width (ResNet-50 FPN, 4
   coarse and 1 fine (self, cross) pairs) with seeded random weights at
   the bench operating point (bf16, fused matching, 2048 matches): 3
   batches of 8 pairs at 832 x 832, one batch with content masks (832 x
   624 on the canvas), one identical-image batch; launch counts of every
   kernel read around this phase;
5. fused against dense matching on the card at 320 px in float32, TF32 off;
6. kernel K2 (refiner_block, the fused ConvRefiner block) against its
   plain version at the four main-path shapes of gim_roma and the four of
   gim_dkm in bf16 and on ragged cases (C 40 -> 56, widths 200 and 203;
   192 -> 144) in float32 and bf16, with timings of kernel, plain version
   and the switches-off block (PyTorch's depthwise conv, BN, ReLU, 1x1
   conv) beside the bound;
7. kernel K3 (flash_attention) against its plain version on the strided
   q, k, v views of a qkv split at the ViT-L (2, 16, 2305, 64) and
   coordinate-decoder (2, 8, 2304, 128) shapes in bf16 and on ragged
   cases (contiguous and strided, float32 and bf16), with
   `F.scaled_dot_product_attention`'s time on the same views as the
   library yardstick (the port never calls it);
8. main path of gim_roma: `Matcher("gim_roma")` at full width (DINOv2
   ViT-L/14, VGG19-bn, GP, 5-block decoder, five ConvRefiners, 672 ->
   1344 px, 5000 balanced samples) at the operating point (bf16,
   GIM_TPU_FUSED_REFINER=1, GIM_TPU_FLASH_VIT=1): one warm-up and 3 timed
   calls of 1 pair, one call with content masks; 32 K2 and 29 K3 launches
   asserted per call; stage times and a profile;
9. gim_roma with both switches on against both off, float32, TF32 off,
   224 -> 448 px: warp and certainty agree;
10. main path of gim_dkm: `Matcher("gim_dkm")` at full width (ResNet-50
   pyramid, GP and DFN at 1/32 and 1/16, five ConvRefiners) at its
   operating point (bf16, GIM_TPU_FUSED_REFINER=1) on 1 pair of 840 x 840
   canvases with content masks of 840 x 630 (the ZEB protocol: 660 x 880
   -> 1152 x 1536, 5000 balanced samples): one warm-up and 3 timed calls,
   one call without masks (aspect-pad); 32 K2 launches asserted per call;
   stage times and a profile;
11. gim_dkm with the switch on against off, float32, TF32 off, 240 x 320
   -> 384 x 512: warp and certainty agree.

Any failed phase makes the script exit nonzero. On success the last two
lines are the kernels' JSON summary and {"ok": true, "device": ...}.
Exits nonzero without a result when CUDA is not available or the package
is not beside the script.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W); exp2 on the
# MUFU: 16 a clock per SM on 132 SMs at the 1.83 GHz that 989 TFLOP/s
# implies (132 SMs x 4 tensor cores x 1024 bf16 FLOP a clock)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EX2 = 16 * 132 * PEAK_BF16_FLOPS / (132 * 4 * 1024)

BATCH, IMG = 8, 832
TOL_BF16, TOL_F32, MIN_AGREE = 1e-2, 1e-4, 0.999
# K2 / K3 against their plain versions: bf16 as the JAX package's bf16
# flash test (tests/test_pallas_kernels.py), float32 as its f32 tests
RTOL_BF16, ATOL_BF16, TOL_ATTN_F32 = 0.05, 0.02, 2e-4

# gim_roma at the operating point: the refiner blocks K2 runs, 8 hidden
# blocks each (coarse pass 672 px, upsample pass 1344 px, 2 images)
HIDDEN_BLOCKS = 8
REFINER_SHAPES = ((2, 144, 336, 336), (2, 24, 672, 672), (2, 144, 672, 672),
                  (2, 24, 1344, 1344))
# K3: (G, N, D) and launches per call -- DINOv2 ViT-L (2 images x 16 heads,
# 48^2 + 1 tokens) and the coordinate decoder (2 x 8 heads, 48^2 tokens)
FLASH_SHAPES = (((32, 2305, 64), 24), ((16, 2304, 128), 5))
ROMA_IMG = 672
ROMA_K2_PER_CALL = 4 * HIDDEN_BLOCKS
# gim_dkm at the operating point: hidden blocks 144 (scale 2) and 24
# (scale 1) wide, at 660 x 880 and 1152 x 1536, 2 images; the ZEB canvas
# (gim_tpu/data/zeb.py:48) and a landscape image's content on it
DKM_REFINER_SHAPES = ((2, 144, 330, 440), (2, 24, 660, 880),
                      (2, 144, 576, 768), (2, 24, 1152, 1536))
DKM_K2_PER_CALL = 4 * HIDDEN_BLOCKS
DKM_CANVAS, DKM_CONTENT = 840, (630, 840)     # (h, w) of the content
ROMA_K3_PER_CALL = sum(n for _, n in FLASH_SHAPES)
SWITCH_TOL = 1e-3     # warp (normalized coordinates) and certainty


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


@contextlib.contextmanager
def switches(on: bool):
    """GIM_TPU_FUSED_REFINER and GIM_TPU_FLASH_VIT set to "1" or "0"."""
    names = ("GIM_TPU_FUSED_REFINER", "GIM_TPU_FLASH_VIT")
    old = {k: os.environ.get(k) for k in names}
    os.environ.update({k: "1" if on else "0" for k in names})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_terms(flops: float, nbytes: float, exps: float = 0.0):
    """Least ms for each resource of bf16 work: tensor-core products, MUFU
    exp2s and device-memory bytes."""
    return {"products": flops / PEAK_BF16_FLOPS * 1e3,
            "exp2": exps / PEAK_EX2 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}


def bound(flops: float, nbytes: float, exps: float = 0.0):
    """Least ms for bf16 work: the largest of the terms, and whether
    operations (products, exp2s) or bytes set it."""
    terms = bound_terms(flops, nbytes, exps)
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations"


def sweep_costs(B: int, L: int, S: int, C: int, n_blocks: int):
    """Work of each K1 sweep over (B, L, C) x (B, S, C) bf16 features:
    product FLOPs, exp2s, bytes (each input read once, each output written
    once) of the stats and the argmax sweep. Stats take two exp2s per score
    (row side and column side); argmax none."""
    flops = 2.0 * B * L * S * C
    inputs = 2.0 * B * (L + S) * C + 4.0 * B * (L + S)      # features, masks
    outputs = 2 * 4.0 * B * L + 2 * 4.0 * B * n_blocks * S  # rows, partials
    return {"dsmax_stats": (flops, 2.0 * B * L * S, inputs + outputs),
            "dsmax_argmax": (flops, 0.0,
                             inputs + 4.0 * B * (L + S) + outputs)}


class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.card = ""

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:  # report every phase, fail at the end
            traceback.print_exc(file=sys.stdout)
            print(f"== {name}: FAILED", flush=True)
            self.failed.append(name)

    # -- 1 ------------------------------------------------------------------
    def environment(self):
        import torch

        from gim_tpu_torch.utils.device import set_tf32

        set_tf32(False)
        self.card = nvidia_smi()
        print(f"card: {self.card}")
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
              f"{torch.backends.cudnn.allow_tf32}")

    # -- 2 ------------------------------------------------------------------
    def build(self):
        from gim_tpu_torch.ops.kernels.build import build_all

        t0 = time.perf_counter()
        logs = build_all()
        print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"  {name}: {line.strip()}")

    # -- 3 ------------------------------------------------------------------
    def kernels_vs_plain(self):
        import torch

        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        B, L, C = BATCH, (IMG // 8) ** 2, 256
        hc = IMG // 8

        def feats(b, l, s, dtype):
            f0 = torch.randn(b, l, C, device=dev, generator=g) / C ** 0.25
            f1 = torch.randn(b, s, C, device=dev, generator=g) / C ** 0.25
            return f0.to(dtype), f1.to(dtype)

        def agreement(label, got, want, valid, tol, exact=False):
            jb, cf, mu = got
            wjb, wcf, wmu = want
            v = valid if valid is not None else torch.ones_like(wmu)
            n = int(v.sum())
            j_ok = (jb == wjb) & v
            j_share = float(j_ok.sum()) / n
            m_share = float(((mu == wmu) & v).sum()) / n
            both = j_ok & (wcf > 0)
            rel = float(((cf - wcf).abs() / wcf)[both].max())
            print(f"  {label}: rows {n}, j_best agrees {j_share:.6f}, mutual "
                  f"agrees {m_share:.6f}, max rel conf diff {rel:.3e} "
                  f"(limit {'exact' if exact else MIN_AGREE}, conf {tol})")
            need = 1.0 if exact else MIN_AGREE
            assert j_share >= need and m_share >= need and rel <= tol, label

        print("  (near-ties may flip under another summation order; the "
              "limits allow 0.1 % of rows for that)")
        # well separated: f1 is a permutation of f0 plus small noise
        f0 = torch.randn(B, L, C, device=dev, generator=g) / C ** 0.25
        perm = torch.randperm(L, device=dev, generator=g)
        f1 = f0[:, perm] + 0.05 * torch.randn(B, L, C, device=dev,
                                              generator=g) / C ** 0.25
        f0, f1 = f0.bfloat16(), f1.bfloat16()
        agreement("bf16 separated", K.dual_softmax_mutual(f0, f1, 0.1),
                  K.dual_softmax_mutual_plain(f0, f1, 0.1), None, TOL_BF16,
                  exact=True)

        f0, f1 = feats(B, L, L, torch.bfloat16)
        agreement("bf16 random", K.dual_softmax_mutual(f0, f1, 0.1),
                  K.dual_softmax_mutual_plain(f0, f1, 0.1), None, TOL_BF16)

        # ~25 % masked cells, plus one whole grid row and grid column
        grid = torch.rand(B, hc, hc, device=dev, generator=g) > 0.25
        grid[:, hc // 2, :] = False
        grid[:, :, hc // 3] = False
        m0 = grid.reshape(B, L)
        m1 = torch.roll(grid, 1, dims=0).reshape(B, L)
        print(f"  masked share {1 - float(m0.float().mean()):.3f}")
        agreement("bf16 masked", K.dual_softmax_mutual(f0, f1, 0.1, m0, m1),
                  K.dual_softmax_mutual_plain(f0, f1, 0.1, m0, m1), m0,
                  TOL_BF16)

        r0, r1 = feats(2, 1000, 1300, torch.float32)
        agreement("f32 ragged L=1000 S=1300",
                  K.dual_softmax_mutual(r0, r1, 0.1),
                  K.dual_softmax_mutual_plain(r0, r1, 0.1), None, TOL_F32)

        def sweeps(label, f0, f1, m0f, m1f, inv_t):
            """Each sweep against its plain version on the same inputs:
            log-domain statistics within 1e-3, indices on >= 99.9 % of
            rows and column partials. Returns the two errors and the
            argmax sweep's terms."""
            ks = K.dsmax_stats(f0, f1, m0f, m1f, inv_t)
            ps = K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t)
            assert ks[2].shape == ps[2].shape, (ks[2].shape, ps[2].shape)
            err_s = max(float((ks[0] - ps[0]).abs().max()),
                        float((ks[1].log() - ps[1].log()).abs().max()),
                        float((ks[2] - ps[2]).abs().max()),
                        float((ks[3].log() - ps[3].log()).abs().max()))
            rowterm = torch.where(m0f > 0, ps[0] + ps[1].log(),
                                  0.0).contiguous()
            cmax = ps[2].amax(1)
            csum = (ps[3] * torch.exp(ps[2] - cmax[:, None])).sum(1)
            colterm = torch.where(m1f > 0, cmax + csum.clamp_min(1e-30).log(),
                                  0.0).contiguous()
            ka = K.dsmax_argmax(f0, f1, m0f, m1f, colterm, rowterm, inv_t)
            pa = K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm, rowterm,
                                      inv_t)
            j_eq = ka[0] == pa[0]
            i_eq = ka[2] == pa[2]
            j_share = float(j_eq.float().mean())
            i_share = float(i_eq.float().mean())
            err_a = max(float((ka[1] - pa[1])[j_eq].abs().max()),
                        float((ka[3] - pa[3])[i_eq].abs().max()))
            print(f"  {label}: dsmax_stats max abs err of the log-domain "
                  f"statistics {err_s:.3e} (limit 1e-3); dsmax_argmax row "
                  f"index agrees {j_share:.6f}, column partial index agrees "
                  f"{i_share:.6f}, max abs err of the maxima {err_a:.3e} "
                  f"(limits {MIN_AGREE}, 1e-3); {ks[2].shape[1]} row blocks")
            assert err_s <= 1e-3, label
            assert j_share >= MIN_AGREE and i_share >= MIN_AGREE, label
            assert err_a <= 1e-3, label
            return err_s, err_a, colterm, rowterm

        def timed(label, f0, f1, m0f, m1f, colterm, rowterm, inv_t,
                  plain=False):
            """Each sweep's ms beside its bound (products, exp2s, bytes)
            and torch.bmm of the same f0 f1^T; the plain versions' ms too
            when `plain`."""
            b, l, c = f0.shape
            s = f1.shape[1]
            n = -(-l // K.block_rows(f0.dtype))
            t_lib = cuda_ms(lambda: torch.bmm(f0, f1.transpose(1, 2)), 10)
            out = {}
            for name, kfn, pfn in (
                    ("dsmax_stats",
                     lambda: K.dsmax_stats(f0, f1, m0f, m1f, inv_t),
                     lambda: K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t)),
                    ("dsmax_argmax",
                     lambda: K.dsmax_argmax(f0, f1, m0f, m1f, colterm,
                                            rowterm, inv_t),
                     lambda: K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm,
                                                  rowterm, inv_t))):
                flops, exps, nbytes = sweep_costs(b, l, s, c, n)[name]
                t_k = cuda_ms(kfn, 10)
                t_p = cuda_ms(pfn, 2) if plain else None
                terms = bound_terms(flops, nbytes, exps)
                b_ms, b_by = bound(flops, nbytes, exps)
                top = max(terms, key=terms.get)
                print(f"  {label} {name}: kernel {t_k:.3f} ms, "
                      f"{flops / t_k / 1e9:.1f} TFLOP/s, {t_k / b_ms:.2f}x "
                      f"its bound {b_ms:.3f} ms (set by {top}: products "
                      f"{terms['products']:.3f}, exp2 {terms['exp2']:.3f}, "
                      f"bytes {terms['bytes']:.3f}), {t_k / t_lib:.2f}x "
                      f"torch.bmm {t_lib:.3f} ms"
                      + (f", plain {t_p:.3f} ms" if plain else "")
                      + f" [{self.card}]")
                out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=t_lib)
            return out

        # main-path shapes, masked inputs
        m0f, m1f = m0.float(), m1.float()
        inv_t = 10.0
        err_s, err_a, colterm, rowterm = sweeps(
            f"bf16 masked {tuple(f0.shape)}", f0, f1, m0f, m1f, inv_t)

        # ragged bf16 cases through the wgmma path: L and S not multiples of
        # the 128-row blocks or the 64-row tiles; C < 64 (a zero-filled
        # 64-column box); one partial f0 block against the main path's S
        ragged = []
        for b, l, s, c, masked in ((2, 1000, 1300, 256, False),
                                   (1, 70, 90, 32, True),
                                   (1, 100, L, 256, True)):
            r0 = torch.randn(b, l, c, device=dev, generator=g) / c ** 0.25
            r1 = torch.randn(b, s, c, device=dev, generator=g) / c ** 0.25
            r0, r1 = r0.bfloat16(), r1.bfloat16()
            rm0 = rm1 = None
            if masked:
                rm0 = torch.rand(b, l, device=dev, generator=g) > 0.25
                rm1 = torch.rand(b, s, device=dev, generator=g) > 0.25
            label = f"bf16 ragged {(b, l, s, c)}{' masked' if masked else ''}"
            agreement(label, K.dual_softmax_mutual(r0, r1, 0.1, rm0, rm1),
                      K.dual_softmax_mutual_plain(r0, r1, 0.1, rm0, rm1),
                      rm0, TOL_BF16)
            rm0f = (torch.ones(b, l, device=dev) if rm0 is None
                    else rm0.float())
            rm1f = (torch.ones(b, s, device=dev) if rm1 is None
                    else rm1.float())
            _, _, ct, rt = sweeps(label, r0, r1, rm0f, rm1f, inv_t)
            ragged.append((label, r0, r1, rm0f, rm1f, ct, rt))

        # timings: main-path shapes, then the ragged cases
        main = timed(f"bf16 {tuple(f0.shape)} x {tuple(f1.shape)}", f0, f1,
                     m0f, m1f, colterm, rowterm, inv_t, plain=True)
        for name, t in main.items():
            self.kernels[name] = {
                "name": name, "route": "cuda",
                "source": "gim_tpu_torch/csrc/dsmax.cu",
                "replaces": ("gim_tpu/ops/pallas_kernels/dsmax.py:48"
                             if name == "dsmax_stats" else
                             "gim_tpu/ops/pallas_kernels/dsmax.py:80"),
                "launches": 0, "max_abs_err": err_s if name == "dsmax_stats"
                else err_a, **t}
        for label, *args in ragged:
            timed(label, *args, inv_t)
        t_all = cuda_ms(lambda: K.dual_softmax_mutual(f0, f1, 0.1, m0, m1), 5)
        t_dense = cuda_ms(lambda: K.dual_softmax_mutual_plain(
            f0, f1, 0.1, m0, m1), 2)
        print(f"  dual_softmax_mutual (2 sweeps + reductions) {t_all:.3f} ms, "
              f"dense plain {t_dense:.3f} ms [{self.card}]")
        block = K.block_rows(f0.dtype)
        n_blocks = -(-L // block)
        print(f"  partials: {4 * B * n_blocks * L * 4 / 1e6:.1f} MB for "
              f"{n_blocks} row blocks of {block}")

    # -- 4 ------------------------------------------------------------------
    def main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, LoFTRConfig
        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        cfg = GimConfig(loftr=LoFTRConfig(dtype="bfloat16",
                                          fused_matching=True,
                                          max_matches=2048))
        t0 = time.perf_counter()
        m = Matcher("gim_loftr", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
        g = torch.Generator(device=dev).manual_seed(1)
        shape = (BATCH, 3, IMG, IMG)
        batches = [(torch.rand(shape, device=dev, generator=g),
                    torch.rand(shape, device=dev, generator=g))
                   for _ in range(3)]
        sane = Matcher("gim_loftr", GimConfig(loftr=LoFTRConfig(
            dtype="bfloat16", fused_matching=True, max_matches=2048,
            match_threshold=0.0)), state_dict=m.model.state_dict(),
            device="cuda")

        def check(r):
            assert r.kpts0.shape == (BATCH, 2048, 2), r.kpts0.shape
            assert r.kpts1.shape == (BATCH, 2048, 2)
            for t in (r.kpts0, r.kpts1, r.conf):
                assert bool(torch.isfinite(t).all())

        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        calls = 0
        m.match(*batches[0])                      # warm-up
        calls += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for a, b in batches:
            t0 = time.perf_counter()
            r = m.match(a, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            calls += 1
            check(r)
            for k, n in K.LAUNCHES.items():
                assert n == calls, (k, n, calls)
        peak = torch.cuda.max_memory_allocated()

        # content masks: 832 x 624 content on the 832 x 832 canvas
        mask = torch.zeros(BATCH, IMG, IMG, dtype=torch.bool, device=dev)
        mask[:, :, :624] = True
        a, b = batches[0]
        r = m.match(a * mask[:, None], b * mask[:, None], mask0=mask,
                    mask1=mask)
        calls += 1
        check(r)
        rs = sane.match(a * mask[:, None], b * mask[:, None], mask0=mask,
                        mask1=mask)
        calls += 1
        check(rs)
        inside = rs.kpts0[rs.valid][:, 0] < 624 - 2 * 8
        print(f"  masked batch: {int(r.valid.sum())} valid at threshold "
              f"0.2, {int(rs.valid.sum())} at 0.0, all inside the content "
              f"border: {bool(inside.all())}")
        assert bool(inside.all()) and int(rs.valid.sum()) > 0

        # identical images: most valid matches pair a cell with itself
        r = sane.match(a, a)
        calls += 1
        check(r)
        d = (r.kpts1 - r.kpts0).abs()[r.valid]
        same = float((d < 4.0).all(-1).float().mean())
        print(f"  identical batch: {int(r.valid.sum())} valid matches, "
              f"share with i == j {same:.4f} (limit 0.9)")
        assert int(r.valid.sum()) >= 8 and same >= 0.9
        counts = dict(K.LAUNCHES)
        for k, n in counts.items():
            assert n == calls, (k, n, calls)
            self.kernels[k]["launches"] = n

        ms = statistics.median(times) * 1e3
        print(f"  main path: {calls} match calls, K1 launches {counts}")
        print(f"  batch {BATCH} x {IMG} px bf16 fused: median {ms:.2f} ms "
              f"per batch (runs {[round(t * 1e3, 2) for t in times]}), "
              f"{BATCH / (ms / 1e3):.3f} pairs/s, peak memory "
              f"{peak / 2**30:.2f} GiB [{self.card}]")
        self.stages(m, batches[1])
        self.profile(m, batches[2])

    def timed_call(self, m, args, mods):
        """One `m.match(*args)` with a CUDA event recorded where each of
        `mods` (name: module) starts and ends its forward, a list per name
        (a module that runs twice has four). Returns the events, the
        call's end event and the call's time on the card's stream."""
        import torch

        ev: dict[str, list] = {k: [] for k in mods}

        def mark(key):
            def hook(*_):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev[key].append(e)
            return hook

        handles = []
        for name, mod in mods.items():
            handles.append(mod.register_forward_pre_hook(mark(name)))
            handles.append(mod.register_forward_hook(mark(name)))
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m.match(*args)
            end.record()
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        return ev, end, start.elapsed_time(end)

    def print_stages(self, what, spans, total, rest):
        """Print `spans` (name: ms) of one call of `total` ms, the rest
        of the call under the name `rest`."""
        spans[rest] = total - sum(spans.values())
        print(f"  stages of {what}, {total:.2f} ms on the stream "
              f"[{self.card}]:")
        for name, t in spans.items():
            print(f"    {t:9.3f} ms  {t / total:6.3f}  {name}")

    def stages(self, m, batch):
        """Time on the card's stream between the start and end of each
        stage of one batch; the coarse matching is the gap between the
        coarse transformer and the fine windows."""
        model = m.model
        mods = {"backbone": model.backbone,
                "coarse transformer": model.loftr_coarse,
                "fine windows": model.fine_preprocess,
                "fine transformer": model.loftr_fine}
        ev, _, total = self.timed_call(m, batch, mods)
        spans = {name: ev[name][0].elapsed_time(ev[name][1])
                 for name in mods}
        spans["coarse matching (K1, top-k)"] = ev[
            "coarse transformer"][1].elapsed_time(ev["fine windows"][0])
        self.print_stages("one batch", spans, total,
                          "rest (input cast, expectation, coordinates)")

    def profile(self, m, batch):
        """Device time by kernel for one batch. Informational: a profiler
        that cannot trace the card is reported, not a failed phase."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                m.match(*batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = []   # kernels only: operator rows repeat their time
            for e in prof.key_averages():
                t = e.self_device_time_total
                if e.device_type == DeviceType.CUDA and t > 0:
                    rows.append((t, e.key, e.count))
        except Exception as e:  # noqa: BLE001
            print(f"  profile: not measured ({type(e).__name__}: {e})")
            return
        if not rows:
            print("  profile: not measured (the profiler saw no device time)")
            return
        rows.sort(reverse=True)
        total = sum(t for t, _, _ in rows)
        print(f"  profile: kernels {total / 1e3:.2f} ms in a "
              f"{wall * 1e3:.2f} ms window, busy share "
              f"{total / 1e6 / wall:.3f} [{self.card}]")
        for t, key, n in rows[:20]:
            print(f"    {t / 1e3:9.3f} ms  {n:5d}x  {key[:90]}")

    # -- 5 ------------------------------------------------------------------
    def fused_vs_dense(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, LoFTRConfig

        base = Matcher("gim_loftr", GimConfig(), generator=torch.Generator()
                       .manual_seed(0), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(2)
        a = torch.rand(2, 3, 320, 320, device="cuda", generator=g)
        sets = {}
        for fused in (True, False):
            cfg = GimConfig(loftr=LoFTRConfig(fused_matching=fused,
                                              match_threshold=0.0,
                                              max_matches=512))
            mm = Matcher("gim_loftr", cfg, state_dict=base.model.state_dict(),
                         device="cuda")
            with torch.inference_mode():
                out = mm.model(a, a)
            v = out["valid"].cpu()
            ij = torch.stack([out["i_ids"].cpu(), out["j_ids"].cpu()], -1)
            sets[fused] = {(b, int(i), int(j)) for b in range(2)
                           for (i, j), ok in zip(ij[b].tolist(), v[b]) if ok}
        both = sets[True] & sets[False]
        union = sets[True] | sets[False]
        share = len(both) / max(len(union), 1)
        print(f"  320 px f32, TF32 off: fused {len(sets[True])} / dense "
              f"{len(sets[False])} valid, agreement {share:.4f} (limit 0.99)")
        assert len(union) >= 8 and share >= 0.99

    # -- 6 ------------------------------------------------------------------
    def refiner_vs_plain(self):
        import torch

        from torch import nn

        from gim_tpu_torch.models.dkm.blocks import _run_block
        from gim_tpu_torch.ops.kernels import refiner as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(6)

        def params(C, C_out, dtype):
            """A random block (depthwise 5x5, BN with running statistics,
            ReLU, 1x1 C -> C_out) and its folded kernel inputs."""
            blk = nn.Sequential(
                nn.Conv2d(C, C, 5, padding=2, groups=C), nn.BatchNorm2d(C),
                nn.ReLU(), nn.Conv2d(C, C_out, 1)).to(dev)
            with torch.no_grad():
                for p in blk.parameters():
                    p.copy_(torch.randn(p.shape, device=dev, generator=g)
                            / (p[0].numel() ** 0.5 if p.dim() > 1 else 4.0))
                blk[1].weight.add_(1.0)
                blk[1].running_mean.normal_(0.0, 0.1, generator=g)
                blk[1].running_var.uniform_(0.5, 1.5, generator=g)
            blk.eval().requires_grad_(False)
            folded = [t.to(dtype).contiguous()
                      for t in K.fold_block_params(blk[0], blk[1], blk[3])]
            return blk, folded

        # ragged cases: C != C_out, H and W not tile multiples, an odd
        # width (rows not 16-byte aligned: element loads, not cp.async) and
        # the widest C with a wide C_out (the most shared memory)
        for shape, C_out in (((1, 40, 37, 200), 56), ((1, 40, 37, 203), 56),
                             ((1, 192, 21, 72), 144)):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, device=dev, generator=g).to(dtype)
                _, f = params(shape[1], C_out, dtype)
                got = K.fused_dw_block(x, *f)
                want = K.fused_dw_block_plain(x.float(),
                                              *(t.float() for t in f))
                err = float((got.float() - want).abs().max())
                rtol, atol = ((TOL_F32, TOL_F32) if dtype == torch.float32
                              else (RTOL_BF16, ATOL_BF16))
                print(f"  {str(dtype)[6:]} ragged {shape} -> {C_out}: max abs "
                      f"err {err:.3e} (limit {atol} + {rtol} |plain|)")
                assert torch.allclose(got.float(), want, rtol=rtol,
                                      atol=atol), (shape, dtype)

        max_err = 0.0
        by = set()
        grand = dict(ms=0.0, plain_ms=0.0, off_ms=0.0, bound_ms=0.0)
        for head, shapes in (("gim_roma", REFINER_SHAPES),
                             ("gim_dkm", DKM_REFINER_SHAPES)):
            tot = dict(ms=0.0, plain_ms=0.0, off_ms=0.0, bound_ms=0.0)
            for shape in shapes:
                B, C, H, W = shape
                x = torch.randn(shape, device=dev, generator=g).bfloat16()
                blk, f = params(C, C, torch.bfloat16)
                got = K.fused_dw_block(x, *f)
                plain = K.fused_dw_block_plain(x, *f)
                want = K.fused_dw_block_plain(x.float(),
                                              *(t.float() for t in f))
                torch.cuda.synchronize()
                err = float((got.float() - want).abs().max())
                err_p = float((got.float() - plain.float()).abs().max())
                ok = torch.allclose(got.float(), want, rtol=RTOL_BF16,
                                    atol=ATOL_BF16)
                del plain, want
                t_k = cuda_ms(lambda: K.fused_dw_block(x, *f), 10)
                t_p = cuda_ms(lambda: K.fused_dw_block_plain(x, *f), 10)
                t_off = cuda_ms(lambda: _run_block(blk, x, torch.bfloat16),
                                10)
                flops = 2.0 * B * H * W * (25 * C + C * C)
                nbytes = 2.0 * B * H * W * (C + C) + 2.0 * (27 * C + C * C)
                b_ms, b_by = bound(flops, nbytes)
                by.add(b_by)
                print(f"  {head} bf16 {shape} -> {C}: max abs err {err:.3e} "
                      f"against the plain version in float32 on the same "
                      f"inputs (limit {ATOL_BF16} + {RTOL_BF16} |plain|), "
                      f"{err_p:.3e} against the plain version in bf16")
                print(f"    kernel {t_k:.3f} ms ({nbytes / t_k / 1e6:.0f} "
                      f"GB/s, {t_k / b_ms:.2f}x its bound {b_ms:.3f} ms "
                      f"({b_by})), plain {t_p:.3f} ms, switches-off block "
                      f"(PyTorch depthwise conv + BN + ReLU + 1x1) "
                      f"{t_off:.3f} ms [{self.card}]")
                assert ok, shape
                max_err = max(max_err, err)
                n = HIDDEN_BLOCKS
                tot["ms"] += n * t_k
                tot["plain_ms"] += n * t_p
                tot["off_ms"] += n * t_off
                tot["bound_ms"] += n * b_ms
                del x, got
            print(f"  per {head} call ({HIDDEN_BLOCKS} blocks at each "
                  f"shape): kernel {tot['ms']:.3f} ms, plain "
                  f"{tot['plain_ms']:.3f} ms, switches-off blocks "
                  f"{tot['off_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms; "
                  f"kernel / bound {tot['ms'] / tot['bound_ms']:.2f} "
                  f"[{self.card}]")
            for k in grand:
                grand[k] += tot[k]
        # the JSON entry: one gim_roma call and one gim_dkm call together
        self.kernels["refiner_block"] = {
            "name": "refiner_block", "route": "cuda",
            "source": "gim_tpu_torch/csrc/refiner.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/refiner.py:39",
            "launches": 0, "max_abs_err": max_err, "ms": grand["ms"],
            "plain_ms": grand["plain_ms"], "bound_ms": grand["bound_ms"],
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": None}

    # -- 7 ------------------------------------------------------------------
    def flash_vs_plain(self):
        import torch
        import torch.nn.functional as F

        from gim_tpu_torch.ops.kernels import flash as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(7)

        def qkv(B, H, N, D, dtype, qscale):
            """q, k, v as the strided (B, H, N, D) views that a ViT block's
            qkv split gives (models/dinov2.py): row stride 3 H D."""
            t = torch.randn(B, N, 3, H, D, device=dev, generator=g)
            t[:, :, 0] *= qscale
            q, k, v = t.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)
            return q, k, v

        for D in K.HEAD_DIMS:
            x = torch.randn(3, 1, 3, 157, D, device=dev, generator=g)
            q, k, v = x[0] * 3.0, x[1], x[2]
            got, want = K.flash_sdpa(q, k, v), K.flash_sdpa_plain(q, k, v)
            err = float((got - want).abs().max())
            print(f"  f32 ragged contiguous (1, 3, 157, {D}): max abs err "
                  f"{err:.3e} (limit {TOL_ATTN_F32} + {TOL_ATTN_F32} |plain|)")
            assert torch.allclose(got, want, rtol=TOL_ATTN_F32,
                                  atol=TOL_ATTN_F32)
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv(2, 3, 157, D, dtype, 3.0)
                got = K.flash_sdpa(q, k, v)
                want = K.flash_sdpa_plain(q.float(), k.float(), v.float())
                err = float((got.float() - want).abs().max())
                rtol, atol = ((TOL_ATTN_F32, TOL_ATTN_F32)
                              if dtype == torch.float32
                              else (RTOL_BF16, ATOL_BF16))
                print(f"  {str(dtype)[6:]} ragged strided (2, 3, 157, {D}) "
                      f"views of qkv (2, 157, 3, 3, {D}): max abs err "
                      f"{err:.3e} (limit {atol} + {rtol} |plain|)")
                assert torch.allclose(got.float(), want, rtol=rtol,
                                      atol=atol)

        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        max_err = 0.0
        by = set()
        for (G, N, D), n in FLASH_SHAPES:
            B, H = 2, G // 2
            q, k, v = qkv(B, H, N, D, torch.bfloat16, 2.0)
            got = K.flash_sdpa(q, k, v)
            plain = K.flash_sdpa_plain(q, k, v)
            want = K.flash_sdpa_plain(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            err_p = float((got.float() - plain.float()).abs().max())
            ok = torch.allclose(got.float(), want, rtol=RTOL_BF16,
                                atol=ATOL_BF16)
            merged = got.transpose(1, 2).reshape(B, N, H * D)
            view = merged.data_ptr() == got.data_ptr()
            del plain, want
            t_k = cuda_ms(lambda: K.flash_sdpa(q, k, v), 10)
            t_p = cuda_ms(lambda: K.flash_sdpa_plain(q, k, v), 10)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                          10)
            flops = 4.0 * G * N * N * D
            b_ms, b_by = bound(flops, 4.0 * G * N * D * 2)
            by.add(b_by)
            print(f"  bf16 strided ({B}, {H}, {N}, {D}): max abs err "
                  f"{err:.3e} against the plain version in float32 on the "
                  f"same inputs (limit {ATOL_BF16} + {RTOL_BF16} |plain|), "
                  f"{err_p:.3e} against the plain version in bf16 (bf16 "
                  f"scores); merge of the heads is a view: {view}")
            print(f"    kernel {t_k:.3f} ms ({flops / t_k / 1e9:.1f} TFLOP/s, "
                  f"{t_k / b_ms:.2f}x its bound {b_ms:.3f} ms ({b_by}), "
                  f"{t_k / t_l:.2f}x F.scaled_dot_product_attention "
                  f"{t_l:.3f} ms), plain {t_p:.3f} ms [{self.card}]")
            assert ok and view, (G, N, D)
            max_err = max(max_err, err)
            tot["ms"] += n * t_k
            tot["plain_ms"] += n * t_p
            tot["library_ms"] += n * t_l
            tot["bound_ms"] += n * b_ms
        print(f"  per gim_roma call (24 ViT-L + 5 decoder attentions): "
              f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"library {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms; kernel / library "
              f"{tot['ms'] / tot['library_ms']:.3f} [{self.card}]")
        self.kernels["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "gim_tpu_torch/csrc/flash.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/flash.py:37",
            "launches": 0, "max_abs_err": max_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if by == {"operations"} else "bytes",
            "library_ms": tot["library_ms"]}

    # -- 8 ------------------------------------------------------------------
    def roma_main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, RoMaConfig
        from gim_tpu_torch.ops.kernels import flash, refiner

        dev = torch.device("cuda")
        counters = (refiner.LAUNCHES, flash.LAUNCHES)
        per_call = {"refiner_block": ROMA_K2_PER_CALL,
                    "flash_attention": ROMA_K3_PER_CALL}
        with switches(True):
            cfg = GimConfig(roma=RoMaConfig(dtype="bfloat16"))
            t0 = time.perf_counter()
            m = Matcher("gim_roma", cfg, generator=torch.Generator()
                        .manual_seed(0), device="cuda")
            print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
            g = torch.Generator(device=dev).manual_seed(8)
            shape = (1, 3, ROMA_IMG, ROMA_IMG)
            pairs = [(torch.rand(shape, device=dev, generator=g),
                      torch.rand(shape, device=dev, generator=g))
                     for _ in range(3)]
            n = cfg.roma.num_samples

            def check(r):
                assert r.kpts0.shape == (1, n, 2), r.kpts0.shape
                assert r.kpts1.shape == (1, n, 2) and r.conf.shape == (1, n)
                for t in (r.kpts0, r.kpts1, r.conf):
                    assert bool(torch.isfinite(t).all())

            for c in counters:
                for k in c:
                    c[k] = 0
            calls = 0

            def counts():
                return {**refiner.LAUNCHES, **flash.LAUNCHES}

            def one(*args, **kw):
                nonlocal calls
                r = m.match(*args, **kw)
                torch.cuda.synchronize()
                calls += 1
                check(r)
                got = counts()
                for k, each in per_call.items():
                    assert got[k] == calls * each, (k, got[k], calls, each)
                return r

            one(*pairs[0])                               # warm-up
            torch.cuda.reset_peak_memory_stats()
            times = []
            for a, b in pairs:
                t0 = time.perf_counter()
                r = one(a, b)
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            print(f"  valid matches per call: {int(r.valid.sum())} of {n}")

            # content masks: 672 x 504 content on the canvas (distort_aspect)
            mask = torch.zeros(1, ROMA_IMG, ROMA_IMG, dtype=torch.bool,
                               device=dev)
            mask[:, :, :ROMA_IMG * 3 // 4] = True
            a, b = pairs[0]
            r = one(a * mask[:, None], b * mask[:, None], mask0=mask,
                    mask1=mask)
            v = r.valid[0]
            inside = bool((r.kpts0[0][v][:, 0] <= ROMA_IMG * 3 // 4).all()
                          and (r.kpts1[0][v][:, 0] <= ROMA_IMG * 3 // 4)
                          .all())
            print(f"  masked call: {int(v.sum())} valid, all inside the "
                  f"content rectangle: {inside}")
            assert inside and int(v.sum()) > 0
            got = counts()
            for k in per_call:
                self.kernels[k]["launches"] = got[k]
            ms = statistics.median(times) * 1e3
            print(f"  main path: {calls} match calls, launches {got} "
                  f"({ROMA_K2_PER_CALL} K2 and {ROMA_K3_PER_CALL} K3 per "
                  f"call)")
            print(f"  1 pair at {ROMA_IMG} px -> {cfg.roma.upsample_res[0]} "
                  f"px, bf16, both kernels on: median {ms:.2f} ms per pair "
                  f"(runs {[round(t * 1e3, 2) for t in times]}), peak memory "
                  f"{peak / 2**30:.2f} GiB [{self.card}]")
            self.roma_stages(m, pairs[1])
            self.profile(m, pairs[2])
        # the GP's solve (2304 x 2304, float32): one batched call against
        # one call per image, which the port makes
        A = torch.randn(2, 2304, 2304, device=dev, generator=g) / 48.0
        A = A @ A.transpose(1, 2) + torch.eye(2304, device=dev)
        rhs = torch.randn(2, 2304, 512, device=dev, generator=g)
        t_b = cuda_ms(lambda: torch.linalg.solve(A, rhs), 3)
        t_r = cuda_ms(lambda: [torch.linalg.solve(A[i], rhs[i])
                               for i in range(2)], 3)
        print(f"  GP solve (2, 2304, 2304) f32: batched {t_b:.3f} ms, one "
              f"call per image {t_r:.3f} ms [{self.card}]")

    def roma_stages(self, m, pair):
        """Time on the card's stream of each stage of one call; VGG and
        the decoder run once per pass."""
        model = m.model
        ev, end, total = self.timed_call(
            m, pair, {"vgg": model.encoder["cnn"], "dinov2": model.dinov2,
                      "decoder": model.decoder})
        vgg, dino, dec = ev["vgg"], ev["dinov2"], ev["decoder"]
        spans = {
            "coarse VGG19 (672 px)": vgg[0].elapsed_time(vgg[1]),
            "DINOv2 ViT-L/14 (K3)": dino[0].elapsed_time(dino[1]),
            "coarse decoder (GP, coordinate decoder K3, 5 refiners, K2)":
                dec[0].elapsed_time(dec[1]),
            "fine VGG19 (1344 px)": vgg[2].elapsed_time(vgg[3]),
            "fine decoder (4 refiners, K2)": dec[2].elapsed_time(dec[3]),
            "warp assembly and sampling": dec[3].elapsed_time(end),
        }
        self.print_stages("one call", spans, total, "rest (resizes, gaps)")

    # -- 9 ------------------------------------------------------------------
    def roma_switches_on_off(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, RoMaConfig
        from gim_tpu_torch.ops.kernels import flash, refiner

        cfg = GimConfig(roma=RoMaConfig(coarse_res=224,
                                        upsample_res=(448, 448)))
        m = Matcher("gim_roma", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(9)
        a = torch.rand(1, 3, 224, 224, device="cuda", generator=g)
        b = torch.roll(a, shifts=(9, 13), dims=(2, 3))
        out = {}
        for on in (True, False):
            before = refiner.LAUNCHES["refiner_block"], \
                flash.LAUNCHES["flash_attention"]
            with switches(on), torch.inference_mode():
                out[on] = m.model(a, b)
            torch.cuda.synchronize()
            after = refiner.LAUNCHES["refiner_block"], \
                flash.LAUNCHES["flash_attention"]
            ran = tuple(y - x for x, y in zip(before, after))
            assert ran == ((ROMA_K2_PER_CALL, ROMA_K3_PER_CALL) if on
                           else (0, 0)), (on, ran)
        for i, name in enumerate(("warp", "cert")):
            d = (out[True][i] - out[False][i]).abs()
            if d.dim() == 4:
                d = d.amax(-1)
            share = float((d <= SWITCH_TOL).float().mean())
            print(f"  {name}: agree within {SWITCH_TOL} on {share:.6f} of "
                  f"pixels (limit {MIN_AGREE}), max diff {float(d.max()):.3e}")
            assert share >= MIN_AGREE, name
        print(f"  224 px -> 448 px, float32, TF32 off, switches on "
              f"(K2 + K3) against off (PyTorch convolutions, plain sdpa)")

    # -- 10 -----------------------------------------------------------------
    def dkm_main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import DKMConfig, GimConfig
        from gim_tpu_torch.ops.kernels import flash, refiner

        dev = torch.device("cuda")
        S = DKM_CANVAS
        h, w = DKM_CONTENT
        with switches(True):
            cfg = GimConfig(dkm=DKMConfig(dtype="bfloat16"))
            t0 = time.perf_counter()
            m = Matcher("gim_dkm", cfg, generator=torch.Generator()
                        .manual_seed(0), device="cuda")
            print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
            g = torch.Generator(device=dev).manual_seed(10)
            mask = torch.zeros(1, S, S, dtype=torch.bool, device=dev)
            mask[:, :h, :w] = True
            shape = (1, 3, S, S)
            pairs = [(torch.rand(shape, device=dev, generator=g) * mask,
                      torch.rand(shape, device=dev, generator=g) * mask,
                      None, None, mask, mask) for _ in range(3)]
            n = cfg.dkm.num_samples

            for c in (refiner.LAUNCHES, flash.LAUNCHES):
                for k in c:
                    c[k] = 0
            calls = 0

            def one(*args):
                """One match call: finite keypoints of the right shapes,
                inside the content rectangle (canvas width for the
                aspect-pad call), 32 K2 launches and no K3 one."""
                nonlocal calls
                r = m.match(*args)
                torch.cuda.synchronize()
                calls += 1
                assert r.kpts0.shape == (1, n, 2), r.kpts0.shape
                assert r.kpts1.shape == (1, n, 2) and r.conf.shape == (1, n)
                for t in (r.kpts0, r.kpts1, r.conf):
                    assert bool(torch.isfinite(t).all())
                v = r.valid[0]
                # aspect-pad: the canvas right-padded to the model's w:h
                hh, ww = ((h, w) if args[4] is not None else
                          (S, round(S * cfg.dkm.w_resized
                                    / cfg.dkm.h_resized)))
                for k in (r.kpts0[0][v], r.kpts1[0][v]):
                    assert bool((k >= 0).all() and (k[:, 0] <= ww).all()
                                and (k[:, 1] <= hh).all())
                got = refiner.LAUNCHES["refiner_block"]
                assert got == calls * DKM_K2_PER_CALL, (got, calls)
                assert flash.LAUNCHES["flash_attention"] == 0
                return r

            one(*pairs[0])                               # warm-up
            torch.cuda.reset_peak_memory_stats()
            times = []
            for p in pairs:
                t0 = time.perf_counter()
                r = one(*p)
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            print(f"  valid matches per call: {int(r.valid.sum())} of {n}, "
                  f"all inside the {w} x {h} content rectangle")
            assert int(r.valid.sum()) > 0

            # aspect-pad: no masks, the canvas right-padded to 840 x 1120
            a, b = pairs[0][:2]
            r = one(a, b, None, None, None, None)
            print(f"  call without masks (aspect-pad): "
                  f"{int(r.valid.sum())} valid")
            assert int(r.valid.sum()) > 0
            got = refiner.LAUNCHES["refiner_block"]
            self.kernels["refiner_block"]["launches"] += got
            ms = statistics.median(times) * 1e3
            print(f"  main path: {calls} match calls, K2 launches {got} "
                  f"({DKM_K2_PER_CALL} per call); the K2 entry's launches "
                  f"now {self.kernels['refiner_block']['launches']} "
                  f"(gim_roma's and gim_dkm's main paths)")
            print(f"  1 pair of {S} x {S} canvases ({w} x {h} content) -> "
                  f"{cfg.dkm.h_resized} x {cfg.dkm.w_resized} -> "
                  f"{cfg.dkm.upsample_res[0]} x {cfg.dkm.upsample_res[1]}, "
                  f"bf16, K2 on: median {ms:.2f} ms per pair (runs "
                  f"{[round(t * 1e3, 2) for t in times]}), peak memory "
                  f"{peak / 2**30:.2f} GiB [{self.card}]")
            self.dkm_stages(m, pairs[1])
            self.profile(m, pairs[2])

    def dkm_stages(self, m, pair):
        """Time on the card's stream of each stage of one call; the
        encoder and the decoder run once per pass."""
        model = m.model
        ev, end, total = self.timed_call(
            m, pair, {"encoder": model.encoder, "decoder": model.decoder})
        enc, dec = ev["encoder"], ev["decoder"]
        c = m.cfg.dkm
        spans = {
            f"coarse encoder ({c.h_resized} x {c.w_resized})":
                enc[0].elapsed_time(enc[1]),
            "coarse decoder (GP and DFN at 1/32 and 1/16, 5 refiners; K2)":
                dec[0].elapsed_time(dec[1]),
            f"upsample encoder ({c.upsample_res[0]} x {c.upsample_res[1]})":
                enc[2].elapsed_time(enc[3]),
            "upsample decoder (4 refiners; K2)": dec[2].elapsed_time(dec[3]),
            "warp assembly and sampling": dec[3].elapsed_time(end),
        }
        self.print_stages("one call", spans, total,
                          "rest (input resizes, gaps)")

    # -- 11 -----------------------------------------------------------------
    def dkm_switch_on_off(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import DKMConfig, GimConfig
        from gim_tpu_torch.ops.kernels import refiner

        cfg = GimConfig(dkm=DKMConfig(h_resized=240, w_resized=320,
                                      upsample_res=(384, 512)))
        m = Matcher("gim_dkm", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        a = torch.rand(1, 3, 240, 320, device="cuda", generator=g)
        b = torch.roll(a, shifts=(9, 13), dims=(2, 3))
        out = {}
        for on in (True, False):
            before = refiner.LAUNCHES["refiner_block"]
            with switches(on), torch.inference_mode():
                out[on] = m.model(a, b)
            torch.cuda.synchronize()
            ran = refiner.LAUNCHES["refiner_block"] - before
            assert ran == (DKM_K2_PER_CALL if on else 0), (on, ran)
        for i, name in enumerate(("warp", "cert")):
            d = (out[True][i] - out[False][i]).abs()
            if d.dim() == 4:
                d = d.amax(-1)
            share = float((d <= SWITCH_TOL).float().mean())
            print(f"  {name}: agree within {SWITCH_TOL} on {share:.6f} of "
                  f"pixels (limit {MIN_AGREE}), max diff {float(d.max()):.3e}")
            assert share >= MIN_AGREE, name
        print("  240 x 320 -> 384 x 512, float32, TF32 off, switch on (K2) "
              "against off (PyTorch convolutions)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import gim_tpu_torch
    except ImportError:
        gim_tpu_torch = None
    if (gim_tpu_torch is None
            or Path(gim_tpu_torch.__file__).resolve().parents[1] != here):
        print("chip_smoke: gim_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2

    torch.set_grad_enabled(False)        # inference only
    t0 = time.perf_counter()
    s = Smoke()
    s.phase("1 environment", s.environment)
    s.phase("2 build", s.build)
    if not s.failed:
        s.phase("3 K1 against its plain version", s.kernels_vs_plain)
        s.phase("4 main path", s.main_path)
        s.phase("5 fused against dense", s.fused_vs_dense)
        s.phase("6 K2 against its plain version", s.refiner_vs_plain)
        s.phase("7 K3 against its plain version", s.flash_vs_plain)
        s.phase("8 gim_roma main path", s.roma_main_path)
        s.phase("9 gim_roma switches on against off",
                s.roma_switches_on_off)
        s.phase("10 gim_dkm main path", s.dkm_main_path)
        s.phase("11 gim_dkm switch on against off", s.dkm_switch_on_off)
    if s.failed:
        print(f"chip_smoke: FAILED phases {s.failed}")
        return 1
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": list(s.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
