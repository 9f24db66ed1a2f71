"""Time variants of K1 (`csrc/dsmax.cu`) on one card, and read where a
block's time goes.

    python -m gim_tpu_torch.ops.kernels.dsmax_probe [NAME=[SOURCE|]FLAGS ...]

Each NAME=SPEC builds SOURCE (default `gim_tpu_torch/csrc/dsmax.cu`, a
path from the root of the checkout) with the extra nvcc FLAGS (e.g.
`-DDSMAX_TIMELINE`) into `build/gim_tpu_torch/probe/`, all builds started
together, then times both bf16 sweeps (CUDA events, mean of 20 calls of
the C entry points, no Python wrapper) at the gim_loftr main-path shape
(8 pairs, L = S = 10816, C = 256, ~25 % masked) and on one f0 block
(1, 128, 10816), and both float32 sweeps at ZEB's shape (1, 11025,
11025, 256, the 840 x 630 content mask: 79 of 105 rows) in the wrapper's
chunks of S, each against the plain version. A variant built with
-DDSMAX_TIMELINE also prints, for one block, the SM clocks of each bf16
warpgroup's turn (waiting for its tile and turn, its product, its
epilogue) and of each float32 tile (waiting for the ring, the product,
the epilogue) beside the FFMA clocks the float32 tile needs at one FFMA
a clock on each of the SM's four schedulers. Without arguments: the
source as it is, and with the timeline.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time

from gim_tpu_torch.ops.kernels import build as B

ROOT = B.PKG_DIR.parent
OUT = B.BUILD_DIR / "probe"
DEFAULT = {"kernel": "", "timeline": "-DDSMAX_TIMELINE"}
SHAPES = ((8, 10816, 10816), (1, 128, 10816))
C, INV_T, BLOCK = 256, 10.0, 128
ZEB_CELLS, ZEB_ROWS = 105, 79       # coarse grid of 840 px, content rows


def _build(variants: dict[str, str]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in variants.items():
        src, flags = spec.split("|", 1) if "|" in spec else (
            "gim_tpu_torch/csrc/dsmax.cu", spec)
        cmd = [B.find_nvcc(), *B.NVCC_FLAGS, f"-I{B.CSRC}", *flags.split(),
               "-o", str(OUT / f"lib{name}.so"), str(ROOT / src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        lines = log.splitlines()
        for i, line in enumerate(lines):   # C = 256 bf16, and float32
            if "Compiling" in line and ("ILi4E" in line or "f32" in line):
                sweep = ("argmax" if "ILi4ELb1" in line or "ILb1E" in line
                         else "stats")
                kind = "f32" if "f32" in line else "bf16"
                print(f"  {name} {kind} {sweep}: {lines[i + 2].strip()} | "
                      f"{lines[i + 3].strip()}")
            if "C7513" in line:
                print(f"  {name}: {line.strip()}")
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        I, P, F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.dsmax_stats.argtypes = [I, P, P, P, P, F, I, I, I, I, I, P, P,
                                    P, P, P]
        lib.dsmax_argmax.argtypes = [I, P, P, P, P, P, P, F, I, I, I, I, I,
                                     P, P, P, P, P]
        lib.dsmax_stats.restype = lib.dsmax_argmax.restype = I
        for fn in ("dsmax_timeline", "dsmax_timeline_f32"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [P]
                getattr(lib, fn).restype = I
        libs[name] = lib
    return libs


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")


def _ms(fn, reps: int = 20) -> float:
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


def _timeline(lib, fn, n_tiles: int) -> str:
    """Mean clocks of block (0, 0) per turn of a warpgroup over its steady
    tiles: waiting for the tile and the turn, the product, the epilogue;
    and the time per tile."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    buf = np.zeros((2, 128, 4), dtype=np.uint64)
    _check(lib.dsmax_timeline(buf.ctypes.data))
    d = buf.astype(np.int64)[:, 4:min(n_tiles // 2, 128) - 2]
    per_tile = (d[0, -1, 1] - d[0, 0, 1]) / (d.shape[1] - 1) / 2
    return (f"wait {np.mean(d[..., 1] - d[..., 0]):.0f}, product "
            f"{np.mean(d[..., 2] - d[..., 1]):.0f}, epilogue "
            f"{np.mean(d[..., 3] - d[..., 2]):.0f}, per tile {per_tile:.0f} "
            f"clocks")


def _timeline_f32(lib, fn, n_tiles: int) -> str:
    """Mean clocks of block (0, 0) per tile over its steady tiles: waiting
    for the ring, the product, the epilogue; against the FFMA clocks of a
    128 x 128 x 256 tile (32768 at 128 FMA lanes)."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    buf = np.zeros((128, 3), dtype=np.uint64)
    _check(lib.dsmax_timeline_f32(buf.ctypes.data))
    d = buf.astype(np.int64)[1:min(n_tiles, 128) - 1]
    wait, prod, epi = (float(np.mean(d[:, k])) for k in range(3))
    need = 128 * 128 * C / 128
    return (f"wait {wait:.0f}, product {prod:.0f}, epilogue {epi:.0f} "
            f"clocks per tile; the product at {need / prod:.3f} of the "
            f"FFMA rate ({need:.0f} clocks), the tile at "
            f"{need / (wait + prod + epi):.3f}")


def _f32(libs: dict, dev, g, st) -> None:
    """Both float32 sweeps at ZEB's shape in the wrapper's chunks."""
    import torch

    from gim_tpu_torch.ops.kernels import dsmax as K

    L = ZEB_CELLS * ZEB_CELLS
    f0 = torch.randn(1, L, C, device=dev, generator=g) / C ** 0.25
    f1 = torch.randn(1, L, C, device=dev, generator=g) / C ** 0.25
    m = (torch.arange(L, device=dev) < ZEB_ROWS * ZEB_CELLS)[None].float()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = K.sweep_chunks(torch.float32, 1, L, L, sms)
    nb = -(-L // K.BLOCK_ROWS[torch.float32])
    ps = K.dsmax_stats_plain(f0, f1, m, m, INV_T, chunks=n)
    rmax, rsum = K.merge_row_stats(ps[0], ps[1])
    rt = torch.where(m > 0, rmax + rsum.log(), 0.0).contiguous()
    cmax = ps[2].amax(1)
    csum = (ps[3] * torch.exp(ps[2] - cmax[:, None])).sum(1)
    ct = torch.where(m > 0, cmax + csum.clamp_min(1e-30).log(),
                     0.0).contiguous()
    pa = K.dsmax_argmax_plain(f0, f1, m, m, ct, rt, INV_T, chunks=n)
    flops = 2.0 * L * L * C
    bmm = _ms(lambda: torch.bmm(f0, f1.transpose(1, 2)), 10)
    print(f"f32 shape {(1, L, L, C)} masked ({ZEB_ROWS} of {ZEB_CELLS} "
          f"rows), {nb} row blocks x {n} chunks on {sms} SMs: torch.bmm "
          f"{bmm:.3f} ms, FP32 bound {flops / 66.9e12 * 1e3:.3f} ms")
    for name, lib in libs.items():
        o = [torch.empty(1, n, L, device=dev), torch.empty(1, n, L,
                                                           device=dev),
             torch.empty(1, nb, L, device=dev), torch.empty(1, nb, L,
                                                            device=dev)]
        a = [torch.empty(1, n, L, device=dev, dtype=torch.int32),
             torch.empty(1, n, L, device=dev),
             torch.empty(1, nb, L, device=dev, dtype=torch.int32),
             torch.empty(1, nb, L, device=dev)]
        ptrs = [t.data_ptr() for t in (f0, f1, m, m)]

        def stats():
            _check(lib.dsmax_stats(1, *ptrs, INV_T, 1, L, L, C, n,
                                   *[t.data_ptr() for t in o], st))

        def argmax():
            _check(lib.dsmax_argmax(1, *ptrs, ct.data_ptr(), rt.data_ptr(),
                                    INV_T, 1, L, L, C, n,
                                    *[t.data_ptr() for t in a], st))

        t_s, t_a = _ms(stats), _ms(argmax)
        err = max(float((o[0] - ps[0]).abs().max()),
                  float((o[1].log() - ps[1].log()).abs().max()),
                  float((o[2] - ps[2]).abs().max()),
                  float((o[3].log() - ps[3].log()).abs().max()))
        agree = min(float((a[0] == pa[0]).float().mean()),
                    float((a[2] == pa[2]).float().mean()))
        print(f"  {name}: f32 stats {t_s:.3f} ms ({flops / t_s / 1e9:.1f} "
              f"TFLOP/s, {t_s / bmm:.2f}x torch.bmm), argmax {t_a:.3f} ms "
              f"({flops / t_a / 1e9:.1f} TFLOP/s, {t_a / bmm:.2f}x); against "
              f"the plain version: stats max abs err {err:.2e}, argmax "
              f"indices agree {agree:.6f}")
        if hasattr(lib, "dsmax_timeline_f32"):
            tiles = -(-K.chunk_span(L, n) // K.CHUNK_TILE)
            print(f"    f32 stats timeline: "
                  f"{_timeline_f32(lib, stats, tiles)}")
            print(f"    f32 argmax timeline: "
                  f"{_timeline_f32(lib, argmax, tiles)}")


def main(argv: list[str]) -> int:
    import torch

    from gim_tpu_torch.ops.kernels import dsmax as K

    variants = dict(a.split("=", 1) for a in argv) if argv else DEFAULT
    t0 = time.perf_counter()
    libs = _build(variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s [{smi}]")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    st = torch.cuda.current_stream().cuda_stream
    for b, l, s in SHAPES:
        f0 = (torch.randn(b, l, C, device=dev, generator=g) / C ** 0.25
              ).bfloat16()
        f1 = (torch.randn(b, s, C, device=dev, generator=g) / C ** 0.25
              ).bfloat16()
        m0 = (torch.rand(b, l, device=dev, generator=g) > 0.25).float()
        m1 = (torch.rand(b, s, device=dev, generator=g) > 0.25).float()
        ps = K.dsmax_stats_plain(f0, f1, m0, m1, INV_T, BLOCK)
        ps = (ps[0][:, 0], ps[1][:, 0], *ps[2:])
        rt = torch.where(m0 > 0, ps[0] + ps[1].log(), 0.0).contiguous()
        cmax = ps[2].amax(1)
        csum = (ps[3] * torch.exp(ps[2] - cmax[:, None])).sum(1)
        ct = torch.where(m1 > 0, cmax + csum.clamp_min(1e-30).log(),
                         0.0).contiguous()
        pa = K.dsmax_argmax_plain(f0, f1, m0, m1, ct, rt, INV_T, BLOCK)
        pa = (pa[0][:, 0], pa[1][:, 0], *pa[2:])
        flops = 2.0 * b * l * s * C
        n = -(-l // BLOCK)
        print(f"shape {(b, l, s, C)}: torch.bmm "
              f"{_ms(lambda: torch.bmm(f0, f1.transpose(1, 2)), 10):.3f} ms, "
              f"products bound {flops / 989e12 * 1e3:.3f} ms")
        for name, lib in libs.items():
            o = [torch.empty(b, l, device=dev), torch.empty(b, l, device=dev),
                 torch.empty(b, n, s, device=dev),
                 torch.empty(b, n, s, device=dev)]
            a = [torch.empty(b, l, device=dev, dtype=torch.int32),
                 torch.empty(b, l, device=dev),
                 torch.empty(b, n, s, device=dev, dtype=torch.int32),
                 torch.empty(b, n, s, device=dev)]
            ptrs = [t.data_ptr() for t in (f0, f1, m0, m1)]

            def stats():
                _check(lib.dsmax_stats(0, *ptrs, INV_T, b, l, s, C, 1,
                                       *[t.data_ptr() for t in o], st))

            def argmax():
                _check(lib.dsmax_argmax(0, *ptrs, ct.data_ptr(),
                                        rt.data_ptr(), INV_T, b, l, s, C, 1,
                                        *[t.data_ptr() for t in a], st))

            t_s, t_a = _ms(stats), _ms(argmax)
            err = max(float((o[0] - ps[0]).abs().max()),
                      float((o[1].log() - ps[1].log()).abs().max()),
                      float((o[2] - ps[2]).abs().max()),
                      float((o[3].log() - ps[3].log()).abs().max()))
            agree = min(float((a[0] == pa[0]).float().mean()),
                        float((a[2] == pa[2]).float().mean()))
            print(f"  {name}: stats {t_s:.3f} ms ({flops / t_s / 1e9:.0f} "
                  f"TFLOP/s), argmax {t_a:.3f} ms ({flops / t_a / 1e9:.0f} "
                  f"TFLOP/s); against the plain version: stats max abs err "
                  f"{err:.2e}, argmax indices agree {agree:.6f}")
            if hasattr(lib, "dsmax_timeline") and b == 1:
                tiles = -(-s // 64)
                print(f"    stats timeline: {_timeline(lib, stats, tiles)}")
                print(f"    argmax timeline: {_timeline(lib, argmax, tiles)}")
    _f32(libs, dev, g, st)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
