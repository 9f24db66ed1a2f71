#!/usr/bin/env python3
"""Drive gim_tpu_torch's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, `nvcc`
(sm_90a) and PyTorch built for CUDA. Phases, each printing what it found:

1. environment: card name and power limit, torch / CUDA versions, TF32;
2. build: every kernel of the path, from the sources in the checkout;
3. kernel K1 (dsmax_stats, dsmax_argmax) against its plain PyTorch
   version at main-path shapes (8 pairs, L = S = 10816 coarse cells of
   832 px, C = 256, bf16; unmasked, masked, well separated) and on a
   ragged float32 case, with timings of kernel, plain version and
   `torch.bmm` of the same f0 f1^T, beside the card's bound;
4. main path: `Matcher("gim_loftr")` at full width (ResNet-50 FPN, 4
   coarse and 1 fine (self, cross) pairs) with seeded random weights at
   the bench operating point (bf16, fused matching, 2048 matches): 3
   batches of 8 pairs at 832 x 832, one batch with content masks (832 x
   624 on the canvas), one identical-image batch; launch counts of every
   kernel read around this phase;
5. fused against dense matching on the card at 320 px in float32, TF32 off;
6. kernel K2 (refiner_block, the fused ConvRefiner block) against its
   plain version at the four main-path shapes of gim_roma in bf16 and on
   a ragged float32 case (C 40 -> 56), with timings of kernel, plain
   version and the switches-off block (PyTorch's depthwise conv, BN, ReLU,
   1x1 conv)
   beside the bound;
7. kernel K3 (flash_attention) against its plain version at the ViT-L
   (32, 2305, 64) and coordinate-decoder (16, 2304, 128) shapes in bf16
   and on ragged float32 cases, with `F.scaled_dot_product_attention`'s
   time as the library yardstick (the port never calls it);
8. main path of gim_roma: `Matcher("gim_roma")` at full width (DINOv2
   ViT-L/14, VGG19-bn, GP, 5-block decoder, five ConvRefiners, 672 ->
   1344 px, 5000 balanced samples) at the operating point (bf16,
   GIM_TPU_FUSED_REFINER=1, GIM_TPU_FLASH_VIT=1): one warm-up and 3 timed
   calls of 1 pair, one call with content masks; 32 K2 and 29 K3 launches
   asserted per call; stage times and a profile;
9. gim_roma with both switches on against both off, float32, TF32 off,
   224 -> 448 px: warp and certainty agree.

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

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

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


def bound(flops: float, nbytes: float):
    """Least ms for bf16 work: the larger of operations and bytes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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

        # each sweep against its plain version on the same inputs (masked)
        m0f, m1f = m0.float(), m1.float()
        inv_t = 10.0
        ks = K.dsmax_stats(f0, f1, m0f, m1f, inv_t)
        ps = K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t)
        err_s = max(float((ks[0] - ps[0]).abs().max()),
                    float((ks[1].log() - ps[1].log()).abs().max()),
                    float((ks[2] - ps[2]).abs().max()),
                    float((ks[3].log() - ps[3].log()).abs().max()))
        print(f"  dsmax_stats vs plain: max abs err of the log-domain "
              f"statistics {err_s:.3e} (limit 1e-3)")
        assert err_s <= 1e-3

        rowterm = torch.where(m0f > 0, ps[0] + ps[1].log(), 0.0).contiguous()
        cmax = ps[2].amax(1)
        csum = (ps[3] * torch.exp(ps[2] - cmax[:, None])).sum(1)
        colterm = torch.where(m1f > 0, cmax + csum.clamp_min(1e-30).log(),
                              0.0).contiguous()
        ka = K.dsmax_argmax(f0, f1, m0f, m1f, colterm, rowterm, inv_t)
        pa = K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm, rowterm, inv_t)
        j_eq = ka[0] == pa[0]
        i_eq = ka[2] == pa[2]
        err_a = max(float((ka[1] - pa[1])[j_eq].abs().max()),
                    float((ka[3] - pa[3])[i_eq].abs().max()))
        print(f"  dsmax_argmax vs plain: row index agrees "
              f"{float(j_eq.float().mean()):.6f}, column partial index "
              f"agrees {float(i_eq.float().mean()):.6f}, max abs err of "
              f"the maxima {err_a:.3e} (limits {MIN_AGREE}, 1e-3)")
        assert float(j_eq.float().mean()) >= MIN_AGREE
        assert float(i_eq.float().mean()) >= MIN_AGREE and err_a <= 1e-3

        # timings at main-path shapes (bf16, masked inputs)
        n_tiles = ks[2].shape[1]
        flops = 2.0 * B * L * L * C
        in_bytes = 2 * B * L * C * 2 + 2 * B * L * 4
        t_lib = cuda_ms(lambda: torch.bmm(f0, f1.transpose(1, 2)), 10)
        for name, kfn, pfn, extra_in, out_bytes in (
                ("dsmax_stats",
                 lambda: K.dsmax_stats(f0, f1, m0f, m1f, inv_t),
                 lambda: K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t),
                 0, 2 * B * L * 4 + 2 * B * n_tiles * L * 4),
                ("dsmax_argmax",
                 lambda: K.dsmax_argmax(f0, f1, m0f, m1f, colterm, rowterm,
                                        inv_t),
                 lambda: K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm,
                                              rowterm, inv_t),
                 2 * B * L * 4, 2 * B * L * 4 + 2 * B * n_tiles * L * 4)):
            t_k = cuda_ms(kfn, 10)
            t_p = cuda_ms(pfn, 2)
            b_ms, b_by = bound(flops, in_bytes + extra_in + out_bytes)
            print(f"  {name}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
                  f"torch.bmm {t_lib:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}); {flops / t_k / 1e9:.1f} TFLOP/s [{self.card}]")
            self.kernels[name] = {
                "name": name, "route": "cuda",
                "source": "gim_tpu_torch/csrc/dsmax.cu",
                "replaces": ("gim_tpu/ops/pallas_kernels/dsmax.py:48"
                             if name == "dsmax_stats" else
                             "gim_tpu/ops/pallas_kernels/dsmax.py:80"),
                "launches": 0, "max_abs_err": err_s if name == "dsmax_stats"
                else err_a, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": t_lib}
        t_all = cuda_ms(lambda: K.dual_softmax_mutual(f0, f1, 0.1, m0, m1), 5)
        t_dense = cuda_ms(lambda: K.dual_softmax_mutual_plain(
            f0, f1, 0.1, m0, m1), 2)
        print(f"  dual_softmax_mutual (2 sweeps + reductions) {t_all:.3f} ms, "
              f"dense plain {t_dense:.3f} ms [{self.card}]")
        print(f"  partials: {4 * B * n_tiles * L * 4 / 1e6:.1f} MB for "
              f"{n_tiles} row tiles of {K.BLOCK_M}")

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

    def stages(self, m, batch):
        """Time on the card's stream between the start and end of each
        stage of one batch (CUDA events recorded by module hooks); the
        coarse matching is the gap between the coarse transformer and the
        fine windows."""
        import torch

        model = m.model
        mods = {"backbone": model.backbone,
                "coarse transformer": model.loftr_coarse,
                "fine windows": model.fine_preprocess,
                "fine transformer": model.loftr_fine}
        ev = {}

        def mark(key):
            def hook(*_):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev[key] = e
            return hook

        handles = []
        for name, mod in mods.items():
            handles.append(mod.register_forward_pre_hook(mark((name, 0))))
            handles.append(mod.register_forward_hook(mark((name, 1))))
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m.match(*batch)
            end.record()
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        spans = {name: ev[(name, 0)].elapsed_time(ev[(name, 1)])
                 for name in mods}
        spans["coarse matching (K1, top-k)"] = ev[
            ("coarse transformer", 1)].elapsed_time(ev[("fine windows", 0)])
        total = start.elapsed_time(end)
        spans["rest (input cast, expectation, coordinates)"] = (
            total - sum(spans.values()))
        print(f"  stages of one batch, {total:.2f} ms on the stream "
              f"[{self.card}]:")
        for name, t in spans.items():
            print(f"    {t:9.3f} ms  {t / total:6.3f}  {name}")

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

        # ragged float32 case: C != C_out, H and W not tile multiples
        x = torch.randn(1, 40, 37, 200, device=dev, generator=g)
        _, f = params(40, 56, torch.float32)
        got, want = K.fused_dw_block(x, *f), K.fused_dw_block_plain(x, *f)
        err = float((got - want).abs().max())
        print(f"  f32 ragged (1, 40, 37, 200) -> 56: max abs err {err:.3e} "
              f"(limit {TOL_F32} + {TOL_F32} |plain|)")
        assert torch.allclose(got, want, rtol=TOL_F32, atol=TOL_F32)

        tot = dict(ms=0.0, plain_ms=0.0, off_ms=0.0, bound_ms=0.0)
        max_err = 0.0
        by = set()
        for shape in REFINER_SHAPES:
            B, C, H, W = shape
            x = torch.randn(shape, device=dev, generator=g).bfloat16()
            blk, f = params(C, C, torch.bfloat16)
            got = K.fused_dw_block(x, *f)
            plain = K.fused_dw_block_plain(x, *f)
            want = K.fused_dw_block_plain(x.float(), *(t.float() for t in f))
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            err_p = float((got.float() - plain.float()).abs().max())
            ok = torch.allclose(got.float(), want, rtol=RTOL_BF16,
                                atol=ATOL_BF16)
            t_k = cuda_ms(lambda: K.fused_dw_block(x, *f), 10)
            t_p = cuda_ms(lambda: K.fused_dw_block_plain(x, *f), 10)
            t_off = cuda_ms(lambda: _run_block(blk, x, torch.bfloat16), 10)
            flops = 2.0 * B * H * W * (25 * C + C * C)
            nbytes = 2.0 * B * H * W * (C + C) + 2.0 * (27 * C + C * C)
            b_ms, b_by = bound(flops, nbytes)
            by.add(b_by)
            print(f"  bf16 {shape} -> {C}: max abs err {err:.3e} against "
                  f"the plain version in float32 on the same inputs (limit "
                  f"{ATOL_BF16} + {RTOL_BF16} |plain|), {err_p:.3e} against "
                  f"the plain version in bf16; kernel {t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms, switches-off block (PyTorch depthwise "
                  f"conv + BN + ReLU + 1x1) {t_off:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}); {nbytes / t_k / 1e6:.0f} GB/s [{self.card}]")
            assert ok, shape
            max_err = max(max_err, err)
            n = HIDDEN_BLOCKS
            tot["ms"] += n * t_k
            tot["plain_ms"] += n * t_p
            tot["off_ms"] += n * t_off
            tot["bound_ms"] += n * b_ms
            del x, got, want
        print(f"  per gim_roma call ({HIDDEN_BLOCKS} blocks at each shape): "
              f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"switches-off blocks {tot['off_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms [{self.card}]")
        self.kernels["refiner_block"] = {
            "name": "refiner_block", "route": "cuda",
            "source": "gim_tpu_torch/csrc/refiner.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/refiner.py:39",
            "launches": 0, "max_abs_err": max_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": None}

    # -- 7 ------------------------------------------------------------------
    def flash_vs_plain(self):
        import torch
        import torch.nn.functional as F

        from gim_tpu_torch.ops.kernels import flash as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(7)

        def qkv(shape, dtype, qscale):
            q, k, v = (torch.randn(shape, device=dev, generator=g)
                       for _ in range(3))
            return (q * qscale).to(dtype), k.to(dtype), v.to(dtype)

        for D in K.HEAD_DIMS:
            q, k, v = qkv((3, 157, D), torch.float32, 3.0)
            got, want = K.flash_sdpa(q, k, v), K.flash_sdpa_plain(q, k, v)
            err = float((got - want).abs().max())
            print(f"  f32 ragged (3, 157, {D}): max abs err {err:.3e} "
                  f"(limit {TOL_ATTN_F32} + {TOL_ATTN_F32} |plain|)")
            assert torch.allclose(got, want, rtol=TOL_ATTN_F32,
                                  atol=TOL_ATTN_F32)

        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        max_err = 0.0
        by = set()
        for (G, N, D), n in FLASH_SHAPES:
            q, k, v = qkv((G, N, D), torch.bfloat16, 2.0)
            got = K.flash_sdpa(q, k, v)
            plain = K.flash_sdpa_plain(q, k, v)
            want = K.flash_sdpa_plain(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            err_p = float((got.float() - plain.float()).abs().max())
            ok = torch.allclose(got.float(), want, rtol=RTOL_BF16,
                                atol=ATOL_BF16)
            del plain, want
            q4, k4, v4 = (t.view(2, G // 2, N, D) for t in (q, k, v))
            t_k = cuda_ms(lambda: K.flash_sdpa(q, k, v), 10)
            t_p = cuda_ms(lambda: K.flash_sdpa_plain(q, k, v), 10)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                          10)
            flops = 4.0 * G * N * N * D
            b_ms, b_by = bound(flops, 4.0 * G * N * D * 2)
            by.add(b_by)
            print(f"  bf16 ({G}, {N}, {D}): max abs err {err:.3e} against "
                  f"the plain version in float32 on the same inputs (limit "
                  f"{ATOL_BF16} + {RTOL_BF16} |plain|), {err_p:.3e} against "
                  f"the plain version in bf16 (bf16 scores); kernel "
                  f"{t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms, F.scaled_dot_product_attention "
                  f"{t_l:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
                  f"{flops / t_k / 1e9:.1f} TFLOP/s [{self.card}]")
            assert ok, (G, N, D)
            max_err = max(max_err, err)
            tot["ms"] += n * t_k
            tot["plain_ms"] += n * t_p
            tot["library_ms"] += n * t_l
            tot["bound_ms"] += n * b_ms
        print(f"  per gim_roma call (24 ViT-L + 5 decoder attentions): "
              f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"library {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms [{self.card}]")
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
        """Time on the card's stream of each stage of one call, from CUDA
        events recorded by module hooks; VGG and the decoder run once per
        pass."""
        import torch

        model = m.model
        mods = {"vgg": model.encoder["cnn"], "dinov2": model.dinov2,
                "decoder": model.decoder}
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
            m.match(*pair)
            end.record()
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
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
        total = start.elapsed_time(end)
        spans["rest (resizes, gaps)"] = total - sum(spans.values())
        print(f"  stages of one call, {total:.2f} ms on the stream "
              f"[{self.card}]:")
        for name, t in spans.items():
            print(f"    {t:9.3f} ms  {t / total:6.3f}  {name}")

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
