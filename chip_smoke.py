#!/usr/bin/env python3
"""Drive gim_tpu_torch's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, `nvcc`
(sm_90a) and PyTorch built for CUDA. Phases, each printing what it found:

1. environment: card name and power limit, torch / CUDA versions, TF32;
2. build: every kernel of the path, from the sources in the checkout;
3. kernel K1 (dsmax_stats, dsmax_argmax) against its plain PyTorch
   version at main-path shapes (8 pairs, L = S = 10816 coarse cells of
   832 px, C = 256, bf16; unmasked, masked, well separated) and on ragged
   bf16 cases through the wgmma path ((2, 1000, 1300, 256); (1, 70, 90,
   32); one partial f0 block against S = 10816, masked), with timings of
   kernel, plain version and `torch.bmm` of the same f0 f1^T, beside the
   card's bound (products, exp2s and bytes, whichever is largest); and
   K1's float32 kernels (dsmax_stats_f32, dsmax_argmax_f32: the SIMT
   kernel, S in chunks) at the same breadth: ragged (2, 1000, 1300, 256),
   (1, 70, 90, 32) masked, (1, 100, 11025, 256) masked and ZEB's shape
   (1, 11025, 11025, 256) with an 840 x 630 content mask, plus planted
   ties across a chunk border and a row-block border (exact), against
   their plain sweeps in the kernel's partial layout and the dense
   recipe, timed beside their FP32-FMA bound and `torch.bmm` in float32
   with TF32 off;
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
   -> 384 x 512: warp and certainty agree;
12. ZEB geometry on the card: `eval.zeb.pair_metrics` (5-point RANSAC with
   the MAGSAC preset, pose errors) on 4 ground-truth scenes of 8192 slots
   (2000-8192 valid, 30 % and 60 % outliers), against the same call on
   the CPU with the card's uniforms; ms, host syncs, launches and peak
   memory of one call at batch 1; root_sift's device match against the
   CPU on seeded descriptors;
13. the ZEB path: `eval.zeb.evaluate` with the full-width gim_loftr
   matcher in float32 with fused matching (K1's float32 kernels), 8192
   slots at threshold 0, on 8 in-memory pairs of 840^2 canvases at batch
   1; one launch of each float32 sweep per pair asserted; ms per pair
   split into match and pair_metrics; the dump read back.

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
# float32 outside the tensor cores (data sheet, 67 TFLOP/s): 132 SMs x 128
# FP32 lanes x 2 FLOP at the 1.98 GHz boost clock; phase 3 prints the rate
# that the card's own maximum SM clock gives
PEAK_F32_FLOPS = 66.9e12
FP32_LANES_PER_SM = 128

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
BF16_SWEEPS = ("dsmax_stats", "dsmax_argmax")
F32_SWEEPS = ("dsmax_stats_f32", "dsmax_argmax_f32")
# ZEB evaluation of gim_loftr (gim_tpu/cli/zeb_eval.py defaults): float32,
# fused matching, batch 1 of 840^2 canvases (the 840 x 630 content of a
# landscape image: 79 of 105 coarse rows), 8192 match slots, the MAGSAC
# preset (2048 hypotheses, PROSAC on the match confidences)
ZEB_CANVAS, ZEB_CONTENT = DKM_CANVAS, DKM_CONTENT
ZEB_MATCHES, ZEB_PAIRS = 8192, 8
# ground-truth scenes of phase 12: (valid slots, inlier share); pixel noise
# 0.1 px against RANSAC's 0.5 px threshold. With noise near the threshold
# the IRLS refits reach other local optima under rounding alone, in the
# JAX package too (its jitted and eager runs), so card and CPU are held
# to one optimum only where the problem has one
ZEB_SCENES = ((8192, 0.7), (2000, 0.4), (5000, 0.7), (8192, 0.4))
ZEB_NOISE_PX = 0.1
POSE_MAX_DEG, POSE_DIFF_DEG, MASK_AGREE = 2.0, 0.5, 0.99


def nvidia_smi(query: str = "name,power.limit", units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60)
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


def bound_terms(flops: float, nbytes: float, exps: float = 0.0,
                peak: float = PEAK_BF16_FLOPS):
    """Least ms for each resource: products at `peak` (bf16 tensor cores by
    default; PEAK_F32_FLOPS for float32 FMA), MUFU exp2s and device-memory
    bytes."""
    return {"products": flops / peak * 1e3,
            "exp2": exps / PEAK_EX2 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}


def bound(flops: float, nbytes: float, exps: float = 0.0,
          peak: float = PEAK_BF16_FLOPS):
    """Least ms: the largest of the terms, and whether operations
    (products, exp2s) or bytes set it."""
    terms = bound_terms(flops, nbytes, exps, peak)
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations"


def sweep_costs(B: int, L: int, S: int, C: int, n_blocks: int,
                elt: int = 2, chunks: int = 1):
    """Work of each K1 sweep over (B, L, C) x (B, S, C) features of `elt`
    bytes: product FLOPs, exp2s, bytes (each input read once, each output
    written once: row partials over `chunks` chunks of S, column partials
    over `n_blocks` row blocks) of the stats and the argmax sweep. Stats
    take two exp2s per score (row side and column side); argmax none."""
    flops = 2.0 * B * L * S * C
    inputs = elt * B * (L + S) * C + 4.0 * B * (L + S)      # features, masks
    outputs = 2 * 4.0 * B * L * chunks + 2 * 4.0 * B * n_blocks * S
    return {"dsmax_stats": (flops, 2.0 * B * L * S, inputs + outputs),
            "dsmax_argmax": (flops, 0.0,
                             inputs + 4.0 * B * (L + S) + outputs)}


class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.card = ""
        self.dev = "cuda"     # phases 12-13 read it; main() needs CUDA

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

        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def chunks_of(f0, f1):
            return K.sweep_chunks(f0.dtype, f0.shape[0], f0.shape[1],
                                  f1.shape[1], sms)

        def sweeps(label, f0, f1, m0f, m1f, inv_t):
            """Each sweep against its plain version on the same inputs, in
            the kernel's layout (row partials over the wrapper's chunks of
            S, column partials over row blocks): log-domain statistics
            within 1e-3, indices on >= 99.9 % of row and column partials.
            Returns the two errors, the argmax sweep's terms and both
            sweeps' partials (kernel, plain)."""
            n = chunks_of(f0, f1)
            ks = K.stats_sweep(f0, f1, m0f, m1f, inv_t, n)
            ps = K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t, chunks=n)
            assert [k.shape for k in ks] == [p.shape for p in ps], label
            err_s = max(float((ks[0] - ps[0]).abs().max()),
                        float((ks[1].log() - ps[1].log()).abs().max()),
                        float((ks[2] - ps[2]).abs().max()),
                        float((ks[3].log() - ps[3].log()).abs().max()))
            rmax, rsum = K.merge_row_stats(ps[0], ps[1])
            rowterm = torch.where(m0f > 0, rmax + rsum.log(),
                                  0.0).contiguous()
            cmax = ps[2].amax(1)
            csum = (ps[3] * torch.exp(ps[2] - cmax[:, None])).sum(1)
            colterm = torch.where(m1f > 0, cmax + csum.clamp_min(1e-30).log(),
                                  0.0).contiguous()
            ka = K.argmax_sweep(f0, f1, m0f, m1f, colterm, rowterm, inv_t, n)
            pa = K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm, rowterm,
                                      inv_t, chunks=n)
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
                  f"(limits {MIN_AGREE}, 1e-3); {ks[2].shape[1]} row blocks x "
                  f"{n} chunks of S")
            assert err_s <= 1e-3, label
            assert j_share >= MIN_AGREE and i_share >= MIN_AGREE, label
            assert err_a <= 1e-3, label
            return err_s, err_a, colterm, rowterm, (ka, pa)

        def timed(label, f0, f1, m0f, m1f, colterm, rowterm, inv_t,
                  plain=False):
            """Each sweep's ms beside its bound (products, exp2s, bytes)
            and torch.bmm of the same f0 f1^T; the plain versions' ms too
            when `plain`."""
            b, l, c = f0.shape
            s = f1.shape[1]
            n = -(-l // K.block_rows(f0.dtype))
            ch = chunks_of(f0, f1)
            f32 = f0.dtype == torch.float32
            peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
            t_lib = cuda_ms(lambda: torch.bmm(f0, f1.transpose(1, 2)), 10)
            out = {}
            for name, kfn, pfn in (
                    ("dsmax_stats",
                     lambda: K.stats_sweep(f0, f1, m0f, m1f, inv_t, ch),
                     lambda: K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t,
                                                 chunks=ch)),
                    ("dsmax_argmax",
                     lambda: K.argmax_sweep(f0, f1, m0f, m1f, colterm,
                                            rowterm, inv_t, ch),
                     lambda: K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm,
                                                  rowterm, inv_t,
                                                  chunks=ch))):
                flops, exps, nbytes = sweep_costs(b, l, s, c, n,
                                                  4 if f32 else 2, ch)[name]
                t_k = cuda_ms(kfn, 10)
                t_p = cuda_ms(pfn, 2) if plain else None
                terms = bound_terms(flops, nbytes, exps, peak)
                b_ms, b_by = bound(flops, nbytes, exps, peak)
                top = max(terms, key=terms.get)
                print(f"  {label} {name}{'_f32' if f32 else ''}: kernel "
                      f"{t_k:.3f} ms, "
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
        err_s, err_a, colterm, rowterm, _ = sweeps(
            f"bf16 masked {tuple(f0.shape)}", f0, f1, m0f, m1f, inv_t)

        def ragged_cases(kind, dtype, s_main, tol, gen):
            """Ragged cases: L and S not multiples of the kernels' blocks
            or tiles; C < 64 (bf16: a zero-filled 64-column box); one
            partial f0 block against the main path's S, masked. Each
            against the dense recipe and its plain sweeps; returns the
            timing arguments."""
            out = []
            for b, l, s, c, masked in ((2, 1000, 1300, 256, False),
                                       (1, 70, 90, 32, True),
                                       (1, 100, s_main, 256, True)):
                r0 = (torch.randn(b, l, c, device=dev, generator=gen)
                      / c ** 0.25).to(dtype)
                r1 = (torch.randn(b, s, c, device=dev, generator=gen)
                      / c ** 0.25).to(dtype)
                rm0 = rm1 = None
                if masked:
                    rm0 = torch.rand(b, l, device=dev, generator=gen) > 0.25
                    rm1 = torch.rand(b, s, device=dev, generator=gen) > 0.25
                label = (f"{kind} ragged {(b, l, s, c)}"
                         f"{' masked' if masked else ''}")
                agreement(label, K.dual_softmax_mutual(r0, r1, 0.1, rm0, rm1),
                          K.dual_softmax_mutual_plain(r0, r1, 0.1, rm0, rm1),
                          rm0, tol)
                rm0f = (torch.ones(b, l, device=dev) if rm0 is None
                        else rm0.float())
                rm1f = (torch.ones(b, s, device=dev) if rm1 is None
                        else rm1.float())
                _, _, ct, rt, _ = sweeps(label, r0, r1, rm0f, rm1f, inv_t)
                out.append((label, r0, r1, rm0f, rm1f, ct, rt))
            return out

        # ragged bf16 cases through the wgmma path (64-row tiles)
        ragged = ragged_cases("bf16", torch.bfloat16, L, TOL_BF16, g)

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
        self.k1_f32(feats, agreement, sweeps, timed, inv_t, chunks_of,
                    ragged_cases)

    def k1_f32(self, feats, agreement, sweeps, timed, inv_t, chunks_of,
               ragged_cases):
        """K1's float32 kernels (the ZEB path, phase 13) at the bf16
        cases' breadth: ragged shapes, masked and not, one partial f0 block
        against ZEB's S; planted ties across a chunk border and a row-block
        border; ZEB's shape, one pair of 840^2 canvases, 105^2 coarse
        cells, C = 256, the content mask of 840 x 630 (79 of 105 rows) on
        both images, timed."""
        import torch

        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(7)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = nvidia_smi("clocks.max.sm", units=False)
        try:
            rate = sms * FP32_LANES_PER_SM * 2 * float(clock) * 1e6
            print(f"  FP32 FMA peak from the card's clock: {sms} SMs x "
                  f"{FP32_LANES_PER_SM} lanes x 2 x {clock} MHz = "
                  f"{rate / 1e12:.1f} TFLOP/s (bound uses "
                  f"{PEAK_F32_FLOPS / 1e12:.1f})")
        except ValueError:
            print(f"  FP32 FMA peak: clock not read ({clock})")
        hc = ZEB_CANVAS // 8
        L = hc * hc
        ragged = ragged_cases("f32", torch.float32, L, TOL_F32, g)

        self.k1_f32_ties(agreement, sweeps, inv_t, chunks_of, g)

        z0, z1 = feats(1, L, L, torch.float32)
        rows = -(-ZEB_CONTENT[0] // 8)
        zm = (torch.arange(L, device=z0.device) < rows * hc)[None]
        zmf = zm.float()
        n = chunks_of(z0, z1)
        n_rb = -(-L // K.block_rows(z0.dtype))
        print(f"  f32 ZEB grid: {n_rb} row blocks x {n} chunks of "
              f"{K.chunk_span(L, n)} columns = {n_rb * n} blocks on {sms} "
              f"SMs ({n_rb * n / sms:.3f} waves)")
        label = f"f32 ZEB {tuple(z0.shape)} masked ({rows} of {hc} rows)"
        agreement(label, K.dual_softmax_mutual(z0, z1, 0.1, zm, zm),
                  K.dual_softmax_mutual_plain(z0, z1, 0.1, zm, zm), zm,
                  TOL_F32)
        err_s, err_a, ct, rt, _ = sweeps(label, z0, z1, zmf, zmf, inv_t)
        for name, t in timed(label, z0, z1, zmf, zmf, ct, rt, inv_t,
                             plain=True).items():
            self.kernels[name + "_f32"] = {
                "name": name + "_f32", "route": "cuda",
                "source": "gim_tpu_torch/csrc/dsmax.cu",
                "replaces": ("gim_tpu/ops/pallas_kernels/dsmax.py:48"
                             if name == "dsmax_stats" else
                             "gim_tpu/ops/pallas_kernels/dsmax.py:80"),
                "launches": 0, "max_abs_err": err_s
                if name == "dsmax_stats" else err_a, **t}
        for label, *args in ragged:
            timed(label, *args, inv_t)

    def k1_f32_ties(self, agreement, sweeps, inv_t, chunks_of, g):
        """Planted ties through the float32 kernels, against the plain
        sweeps and the dense recipe, exact: a row whose two best columns
        lie in different chunks of S, and a column whose two best rows lie
        in different row blocks; both go to the first index."""
        import torch

        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        n, c = 1300, 256
        f0 = torch.randn(1, n, c, device=dev, generator=g) / c ** 0.25
        perm = torch.randperm(n, device=dev, generator=g)
        f1 = f0[:, perm] + 0.05 * torch.randn(1, n, c, device=dev,
                                              generator=g) / c ** 0.25
        ch = chunks_of(f0, f1)
        span = K.chunk_span(n, ch)
        i1, i2 = 5, 1000                  # row blocks 0 and 7
        j1 = next(j for j in range(100, n) if int(perm[j]) not in (i1, i2))
        j2 = next(j for j in range(j1 + span, n)
                  if int(perm[j]) not in (i1, i2))
        f0[:, i2] = f0[:, i1]
        f1[:, j2] = f1[:, j1]
        assert j1 // span != j2 // span and ch > 1, (ch, span, j1, j2)
        got = K.dual_softmax_mutual(f0, f1, 0.1)
        agreement(f"f32 planted ties (1, {n}, {n}, {c}): columns {j1}, {j2} "
                  f"in chunks {j1 // span}, {j2 // span} of {ch}; rows {i1}, "
                  f"{i2} in blocks {i1 // 128}, {i2 // 128}", got,
                  K.dual_softmax_mutual_plain(f0, f1, 0.1), None, TOL_F32,
                  exact=True)
        jb, _, mu = got
        row = int(perm[j1])
        col = int((perm == i1).nonzero()[0, 0])
        assert int(jb[0, row]) == j1 and bool(mu[0, row]), (row, j1)
        assert int(jb[0, i1]) == int(jb[0, i2]) == col, (i1, i2, col)
        assert bool(mu[0, i1]) and not bool(mu[0, i2]), (i1, i2)
        ones = torch.ones(1, n, device=dev)
        *_, (ka, pa) = sweeps("f32 planted ties", f0, f1, ones, ones, inv_t)
        k_row = K.merge_row_argmax(ka[0], ka[1])[0]
        p_row = K.merge_row_argmax(pa[0], pa[1])[0]
        ib_k = ka[2].gather(1, ka[3].argmax(1, keepdim=True))[:, 0]
        ib_p = pa[2].gather(1, pa[3].argmax(1, keepdim=True))[:, 0]
        assert torch.equal(k_row, p_row) and int(k_row[0, row]) == j1
        assert torch.equal(ib_k, ib_p) and int(ib_k[0, col]) == i1
        print(f"  f32 planted ties: row {row} -> column {j1} (not {j2}), "
              f"column {col} -> row {i1} (not {i2}), kernel and plain "
              f"sweeps identical on every row and column")

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
            for k in BF16_SWEEPS:
                assert K.LAUNCHES[k] == calls, (k, K.LAUNCHES[k], calls)
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
        counts = {k: K.LAUNCHES[k] for k in BF16_SWEEPS}
        for k, n in counts.items():
            assert n == calls, (k, n, calls)
            self.kernels[k]["launches"] = n
        assert all(K.LAUNCHES[k] == 0 for k in F32_SWEEPS), K.LAUNCHES

        ms = statistics.median(times) * 1e3
        print(f"  main path: {calls} match calls, K1 launches {counts}")
        print(f"  batch {BATCH} x {IMG} px bf16 fused: median {ms:.2f} ms "
              f"per batch (runs {[round(t * 1e3, 2) for t in times]}), "
              f"{BATCH / (ms / 1e3):.3f} pairs/s, peak memory "
              f"{peak / 2**30:.2f} GiB [{self.card}]")
        self.stages(m, batches[1])
        self.profile(lambda: m.match(*batches[2]))

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

    def profile(self, fn, top: int = 20):
        """Device time by kernel for one `fn()`. Informational: a profiler
        that cannot trace the card is reported, not a failed phase.
        Returns (device launches, device ms, window ms), or None."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = []   # kernels only: operator rows repeat their time
            for e in prof.key_averages():
                t = e.self_device_time_total
                if e.device_type == DeviceType.CUDA and t > 0:
                    rows.append((t, e.key, e.count))
        except Exception as e:  # noqa: BLE001
            print(f"  profile: not measured ({type(e).__name__}: {e})")
            return None
        if not rows:
            print("  profile: not measured (the profiler saw no device time)")
            return None
        rows.sort(reverse=True)
        total = sum(t for t, _, _ in rows)
        launches = sum(n for _, _, n in rows)
        print(f"  profile: {launches} device launches, kernels "
              f"{total / 1e3:.2f} ms in a {wall * 1e3:.2f} ms window, busy "
              f"share {total / 1e6 / wall:.3f} [{self.card}]")
        for t, key, n in rows[:top]:
            print(f"    {t / 1e3:9.3f} ms  {n:5d}x  {key[:90]}")
        return launches, total / 1e3, wall * 1e3

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
            self.profile(lambda: m.match(*pairs[2]))
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
            self.profile(lambda: m.match(*pairs[2]))

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

    # -- 12 -----------------------------------------------------------------
    def zeb_geometry(self):
        import warnings

        import numpy as np
        import torch

        from gim_tpu_torch.eval import zeb as E
        from gim_tpu_torch.geometry.ransac import draw_noise

        dev = torch.device(self.dev)
        n_hyp, _ = E.RANSAC_ZOO["MAGSAC"]
        rng = np.random.default_rng(12)
        scenes = [gt_scene(rng, ZEB_MATCHES, n, w, ZEB_NOISE_PX)
                  for n, w in ZEB_SCENES]
        host = [np.stack(x) for x in zip(*scenes)]    # p0 p1 valid K T
        conf = rng.random(host[0].shape[:2]).astype(np.float32)
        keys = [E.identifier_key(f"zeb_scene{i}#0#1")
                for i in range(len(scenes))]
        p0, p1, valid, K, Tm = (torch.from_numpy(a).to(dev) for a in host)
        c = torch.from_numpy(conf).to(dev)

        def call(sl):
            return E.pair_metrics(p0[sl], p1[sl], valid[sl], K[sl], K[sl],
                                  Tm[sl], keys[sl], 0.5, n_hyp, conf=c[sl])

        card = {k: v.cpu().numpy() for k, v in call(slice(None)).items()}
        # the CPU run takes the card's uniforms: each pair's generator on
        # the card, seeded from its key, drawn again and copied over
        gens = [torch.Generator(dev).manual_seed(E.seed_of(k)) for k in keys]
        noise = tuple(n.cpu() for n in draw_noise(gens, n_hyp, ZEB_MATCHES,
                                                  dev))
        t0 = time.perf_counter()
        cpu = E.pair_metrics(*(torch.from_numpy(a) for a in host[:4]),
                             torch.from_numpy(host[3]),
                             torch.from_numpy(host[4]), keys, 0.5, n_hyp,
                             conf=torch.from_numpy(conf), noise=noise)
        cpu = {k: v.numpy() for k, v in cpu.items()}
        print(f"  {len(scenes)} scenes of {ZEB_MATCHES} slots, {n_hyp} "
              f"hypotheses (MAGSAC preset), {ZEB_NOISE_PX} px noise; the "
              f"CPU run took {time.perf_counter() - t0:.1f} s")
        epi_ok = np.isclose(card["epi_errs"], cpu["epi_errs"], rtol=1e-4,
                            atol=1e-8)
        print(f"  epi_errs: card and CPU agree within rtol 1e-4 + atol "
              f"1e-8 on {epi_ok.mean():.6f} of slots (limit 1)")
        assert epi_ok.all()
        for b, (n, w) in enumerate(ZEB_SCENES):
            v = host[2][b]
            errs = [max(d["R_errs"][b], d["t_errs"][b]) for d in (card, cpu)]
            ok = [bool(np.isfinite(d["R_errs"][b])) for d in (card, cpu)]
            agree = float((card["inliers"][b] == cpu["inliers"][b])[v].mean())
            print(f"  scene {b} ({n} valid, {1 - w:.0%} outliers): max(R, t) "
                  f"error card {errs[0]:.4f} deg, CPU {errs[1]:.4f} deg "
                  f"(limits {POSE_MAX_DEG}, diff {POSE_DIFF_DEG}); "
                  f"success {ok}; inlier masks agree on {agree:.6f} of "
                  f"valid slots (limit {MASK_AGREE}); inliers "
                  f"{int(card['inliers'][b].sum())} / "
                  f"{int(cpu['inliers'][b].sum())}")
            assert ok[0] and ok[1], b
            assert max(errs) < POSE_MAX_DEG, b
            assert abs(errs[0] - errs[1]) < POSE_DIFF_DEG, b
            assert agree >= MASK_AGREE, b

        # ZEB's batch of 1: time, host syncs, launches and memory per call
        one = [slice(b, b + 1) for b in range(len(scenes))]
        call(one[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for sl in one:
            t0 = time.perf_counter()
            call(sl)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call(one[1])
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message)]
        print(f"  pair_metrics, 1 pair of {ZEB_MATCHES} slots: median "
              f"{statistics.median(times):.2f} ms per call (runs "
              f"{[round(t, 2) for t in times]}), {len(syncs)} host syncs "
              f"per call, peak memory {peak / 2**30:.2f} GiB above the "
              f"inputs [{self.card}]")
        for msg in sorted(set(syncs)):
            print(f"    sync: {msg.splitlines()[0][:110]}")
        self.profile(lambda: call(one[2]), top=12)

        # root_sift's device half: the card against the CPU
        from gim_tpu_torch.models.root_sift import match_rootsift

        n = 4096
        d1 = rng.random((n, 128)).astype(np.float32) ** 4
        d1 = np.sqrt(d1 / d1.sum(1, keepdims=True))
        d0 = rng.random((n, 128)).astype(np.float32) ** 4
        d0 = np.sqrt(d0 / d0.sum(1, keepdims=True))
        src = rng.permutation(n)[:n // 2]
        d0[:n // 2] = d1[src] + 0.01 * rng.random((n // 2, 128))
        d0 = (d0 / np.linalg.norm(d0, axis=1, keepdims=True)).astype(
            np.float32)
        k = rng.uniform(0, 840, (n, 2)).astype(np.float32)
        v0, v1 = rng.random(n) > 0.05, rng.random(n) > 0.05
        args = (k, d0, v0, k, d1, v1)
        mc, cc = match_rootsift(*(torch.from_numpy(a).to(dev) for a in args))
        mh, ch = match_rootsift(*(torch.from_numpy(a) for a in args))
        same = bool(torch.equal(mc.cpu(), mh))
        print(f"  match_rootsift on {n} x 128 descriptors: "
              f"{int((mh >= 0).sum())} matches, card and CPU indices "
              f"identical: {same}, max conf diff "
              f"{float((cc.cpu() - ch).abs().max()):.2e}")
        assert same and int((mh >= 0).sum()) > n // 4

    # -- 13 -----------------------------------------------------------------
    def zeb_path(self):
        import tempfile

        import numpy as np
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.cli.analysis import read_dump
        from gim_tpu_torch.config import GimConfig, LoFTRConfig
        from gim_tpu_torch.eval import zeb as E
        from gim_tpu_torch.ops.kernels import dsmax as K

        n_hyp, use_conf = E.RANSAC_ZOO["MAGSAC"]
        cfg = GimConfig(loftr=LoFTRConfig(
            fused_matching=True, max_matches=ZEB_MATCHES,
            match_threshold=0.0))
        m = Matcher("gim_loftr", cfg, generator=torch.Generator()
                    .manual_seed(0), device=self.dev)
        rng = np.random.default_rng(13)
        batches = [zeb_batch(rng, i) for i in range(ZEB_PAIRS + 1)]
        match_s, match_peak = [], []

        def args(batch):
            return tuple(batch[k] for k in ("color0", "color1", "scale0",
                                            "scale1", "mask0", "mask1"))

        def match(batch):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = m.match(*args(batch))
            torch.cuda.synchronize()
            match_s.append(time.perf_counter() - t0)
            match_peak.append(torch.cuda.max_memory_allocated())
            assert r.kpts0.shape == (1, ZEB_MATCHES, 2)
            return r

        stamps = []

        def feed(bs):
            for b in bs:
                stamps.append(time.perf_counter())
                yield b
            stamps.append(time.perf_counter())

        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        E.evaluate(match, feed(batches[:1]), num_hypotheses=n_hyp,
                   use_conf=use_conf, progress=False)          # warm-up
        torch.cuda.synchronize()
        match_s.clear()
        match_peak.clear()
        stamps.clear()
        rows = E.evaluate(match, feed(batches[1:]), num_hypotheses=n_hyp,
                          use_conf=use_conf, progress=False)
        peak = torch.cuda.max_memory_allocated()   # the last pair, whole
        counts = dict(K.LAUNCHES)
        print(f"  K1 launches over {ZEB_PAIRS + 1} pairs (one warm-up): "
              f"{counts}")
        for k in F32_SWEEPS:
            assert counts[k] == ZEB_PAIRS + 1, (k, counts)
            self.kernels[k]["launches"] = counts[k]
        assert all(counts[k] == 0 for k in BF16_SWEEPS), counts

        pair_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        match_ms = [t * 1e3 for t in match_s]
        rest_ms = [p - q for p, q in zip(pair_ms, match_ms)]
        med = statistics.median(pair_ms)
        print(f"  gim_loftr f32, fused (K1 f32), {ZEB_MATCHES} slots at "
              f"threshold 0, {ZEB_PAIRS} pairs of {ZEB_CANVAS}^2 canvases "
              f"at batch 1, MAGSAC preset ({n_hyp} hypotheses): median "
              f"{med:.2f} ms per pair, of which match "
              f"{statistics.median(match_ms):.2f} ms and pair_metrics (with "
              f"the host copies of the rows) "
              f"{statistics.median(rest_ms):.2f} ms; "
              f"{1e3 / med:.3f} pairs/s; peak memory {peak / 2**30:.2f} GiB "
              f"per pair, {max(match_peak) / 2**30:.2f} GiB in the match "
              f"[{self.card}]")
        print(f"    per pair: total {[round(t, 2) for t in pair_ms]}, "
              f"match {[round(t, 2) for t in match_ms]}")

        n_valid = [len(r["epi_errs"]) for r in rows]
        for r in rows:
            assert np.isfinite(r["epi_errs"]).all() and len(r["epi_errs"]) > 0
        with tempfile.TemporaryDirectory() as d:
            path = E.write_dump(rows, d, "gim_loftr", "ZEB-memory", "smoke")
            det = read_dump(path)
        under5 = np.mean([max(float(a), float(b)) < 5.0 for a, b in
                          zip(det["R_errs"], det["t_errs"])])
        print(f"  dump: {len(det['R_errs'])} rows read back by "
              f"cli/analysis.read_dump; valid matches per pair {n_valid}; "
              f"share of pairs under 5 deg {under5:.3f} (seeded random "
              f"weights: no quality claim)")
        assert len(det["R_errs"]) == ZEB_PAIRS
        self.stages(m, args(batches[1]))
        self.profile(lambda: E.evaluate(match, iter(batches[1:2]),
                                        num_hypotheses=n_hyp,
                                        use_conf=use_conf, progress=False),
                     top=12)
        # informational: cuDNN's heuristics pick float32 algorithms (FFT
        # among them) without timing them; the port leaves
        # torch.backends.cudnn.benchmark at PyTorch's default (off)
        torch.backends.cudnn.benchmark = True
        try:
            match(batches[1])                       # autotunes each shape
            match_s.clear()
            for b in batches[1:4]:
                match(b)
        finally:
            torch.backends.cudnn.benchmark = False
        print(f"  match with torch.backends.cudnn.benchmark on (not the "
              f"port's setting): median "
              f"{statistics.median(match_s) * 1e3:.2f} ms per pair (runs "
              f"{[round(t * 1e3, 2) for t in match_s]}), peak "
              f"{max(match_peak) / 2**30:.2f} GiB [{self.card}]")


def gt_scene(rng, m: int, n_valid: int, inlier_share: float,
             noise_px: float, f: float = 600.0, im: int = 840):
    """A ground-truth two-view scene in pixels: random pose and 3D points
    projected through K, Gaussian noise, uniform outliers, the first
    n_valid of m slots valid. Returns p0, p1 (m, 2), valid (m,), K (3, 3),
    T_0to1 (4, 4), float32."""
    import numpy as np

    K = np.array([[f, 0, im / 2], [0, f, im / 2], [0, 0, 1.0]])
    r = rng.uniform(-0.25, 0.25, 3)
    th = np.linalg.norm(r)
    k = r / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    t = rng.standard_normal(3)
    t = 0.5 * t / np.linalg.norm(t)
    X = np.concatenate([rng.uniform(-3, 3, (m, 2)),
                        rng.uniform(4, 12, (m, 1))], -1)
    x0 = X @ K.T
    x1 = (X @ R.T + t) @ K.T
    p0 = x0[:, :2] / x0[:, 2:] + rng.standard_normal((m, 2)) * noise_px
    p1 = x1[:, :2] / x1[:, 2:] + rng.standard_normal((m, 2)) * noise_px
    out = rng.random(m) > inlier_share
    p1[out] = rng.uniform(0, im, (int(out.sum()), 2))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return (p0.astype(np.float32), p1.astype(np.float32),
            np.arange(m) < n_valid, K.astype(np.float32),
            T.astype(np.float32))


def zeb_batch(rng, i: int) -> dict:
    """One ZEB batch (`data/zeb.batch_pairs` format) built in memory: an
    840^2 canvas holding 840 x 630 of blocky texture, and the same texture
    with its left half moved 8 px and its right half 24 px (two planes
    under a sideways move: R = I, t along -x), content masks, K."""
    import numpy as np

    S = ZEB_CANVAS
    h, w = ZEB_CONTENT
    tex = np.repeat(np.repeat(rng.random((3, h // 4 + 1, w // 4)), 4, 1),
                    4, 2)[:, :h].astype(np.float32)
    c0 = np.zeros((1, 3, S, S), np.float32)
    c0[0, :, :h, :w] = tex
    c1 = np.zeros_like(c0)
    half = w // 2
    c1[0, :, :h, 8:half] = tex[:, :, :half - 8]
    c1[0, :, :h, half + 24:w] = tex[:, :, half:w - 24]
    mask = np.zeros((1, S, S), bool)
    mask[0, :h, :w] = True
    K = np.array([[[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]]],
                 np.float32)
    T = np.eye(4, dtype=np.float32)[None].copy()
    T[0, 0, 3] = -1.0
    return {"color0": c0, "color1": c1, "mask0": mask, "mask1": mask,
            "scale0": np.ones((1, 2), np.float32),
            "scale1": np.ones((1, 2), np.float32), "K0": K, "K1": K,
            "T_0to1": T, "identifier": [f"zeb_memory#{i:04d}#{i:04d}s"],
            "covisible0": [0.5], "covisible1": [0.5]}


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
        s.phase("12 ZEB geometry on the card", s.zeb_geometry)
        s.phase("13 ZEB path", s.zeb_path)
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
