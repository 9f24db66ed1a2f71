"""Time K2's and K3's float32 kernels (`csrc/refiner.cu`, `csrc/flash.cu`)
and variants of them on one card, through the wrappers.

    python -m gim_tpu_torch.ops.kernels.f32_probe [NAME=DIR | ABLATION ...]

Each NAME=DIR builds DIR/refiner.cu and DIR/flash.cu (a directory with
those sources and the headers they include, from the root of the
checkout: another checkout's `gim_tpu_torch/csrc` unpacked under a
gitignored directory, or an edited copy). Each ABLATION builds this
checkout's sources with the `F32_PROBE_*` macros that remove one part of
a kernel's work (the results are wrong; only the time is read):

- `no_1x1`: K2 without its 1x1 products (the depthwise side alone);
- `no_depthwise`: K2 without its depthwise FMAs (every channel dead);
- `no_compute`: K2 without either (its loads, rings and stores alone);
- `no_softmax_exp`: K3 with P = S instead of exp2 (softmax's MUFU work).

All builds start together (`build.build_all`). Then each variant in turn
stands in for the wrappers' library and is timed (`chip_smoke.cuda_ms`,
20 calls after one, TF32 off) at the main path's shapes, with its error
against the plain version: K2 at chip_smoke.py's REFINER_SHAPES (gim_roma)
and DKM_REFINER_SHAPES (gim_dkm) with C_out = C on `refiner_block_params`
blocks, K3 at FLASH_SHAPES on the strided views of a qkv split; each
beside its floor (`k2_f32_bounds`, `k3_f32_bounds`). Sources from before
the float32 kernels took a scratch buffer (their plain FMA versions) are
called without one. Without arguments: this checkout's sources.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import sys
import time

from gim_tpu_torch.ops.kernels import build as B

ROOT = B.PKG_DIR.parent
ABLATIONS = {
    "no_1x1": ("-DF32_PROBE_NO_1X1",),
    "no_depthwise": ("-DF32_PROBE_NO_DEPTHWISE",),
    "no_compute": ("-DF32_PROBE_NO_1X1", "-DF32_PROBE_NO_DEPTHWISE"),
    "no_softmax_exp": ("-DF32_PROBE_NO_EXP",),
}


def variants(argv: list[str]) -> dict[str, tuple]:
    """NAME -> (source directory or None for this checkout's, nvcc flags)."""
    out = {}
    for arg in argv or ["kernel=gim_tpu_torch/csrc"]:
        name, _, spec = arg.partition("=")
        if spec:
            out[name] = (ROOT / spec, ())
        elif name in ABLATIONS:
            out[name] = (None, ABLATIONS[name])
        else:
            raise SystemExit(f"{name}: neither NAME=DIR nor one of "
                             f"{sorted(ABLATIONS)}")
    return out


class _NoScratch:
    """A library built from sources from before the float32 kernels took
    a scratch buffer (entry points without that argument), called through
    the wrappers' signatures: the scratch argument is dropped."""

    def __init__(self, lib, name: str):
        P, I = ctypes.c_void_p, ctypes.c_int
        self._lib, self._name = lib, name
        tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P]
        fn = getattr(lib, name)
        fn.argtypes = ([I] + [P] * 6 + [I] * 5 + [P] if name ==
                       "refiner_block" else [I] + [P] * 4 + [I] * 4 + tail)
        fn.restype = I
        self._at = 7 if name == "refiner_block" else 5   # scratch's slot

    def __getattr__(self, attr):
        if attr.endswith("_scratch_bytes"):
            return lambda *a: 0
        if attr == self._name:
            return lambda *a: getattr(self._lib, attr)(
                *a[:self._at], *a[self._at + 1:])
        return getattr(self._lib, attr)


def loaded(refiner, flash, csrc, flags):
    """The variant's K2 and K3 libraries with the wrappers' signatures."""
    libs = []
    for mod, name, entry in ((refiner, "refiner", "refiner_block"),
                             (flash, "flash", "flash_attention")):
        lib = B.load_library(name, csrc, flags)
        libs.append(mod._lib(csrc, flags)
                    if hasattr(lib, f"{name}_scratch_bytes")
                    else _NoScratch(lib, entry))
    return tuple(libs)


def main(argv: list[str]) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gim_tpu_torch.ops.kernels import flash, refiner
    from gim_tpu_torch.utils.device import set_tf32

    if not torch.cuda.is_available():
        print("f32_probe: CUDA is not available", file=sys.stderr)
        return 2
    vs = variants(argv)
    set_tf32(False)
    torch.set_grad_enabled(False)
    card = cs.nvidia_smi()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(vs)) as ex:
        logs = dict(zip(vs, ex.map(
            lambda v: B.build_all(("refiner", "flash"), *v), vs.values())))
    for name, by_src in logs.items():
        for src, log in by_src.items():
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling" in line and "f32_kernel" in line:
                    print(f"  {name} {src}: {lines[i + 1].strip()} | "
                          f"{lines[i + 2].strip()}")
    libs = {name: loaded(refiner, flash, *v) for name, v in vs.items()}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    g = torch.Generator(device="cuda").manual_seed(13)
    floors = {"gim_roma K2": 0.0, "gim_dkm K2": 0.0, "gim_roma K3": 0.0}
    totals = {name: dict.fromkeys(floors, 0.0) for name in vs}

    def timed(label, module, i, fn, want, floor, n, what):
        row = []
        for name in vs:
            with cs.swapped(module, "_lib", lambda name=name: libs[name][i]):
                err = float((fn() - want).abs().max())
                ms = cs.cuda_ms(fn, 20)
            totals[name][what] += n * ms
            row.append(f"{name} {ms:.3f} ({ms / floor:.2f}x, err {err:.1e})")
        floors[what] += n * floor
        print(f"{label} floor {floor:.3f} ms: " + ", ".join(row), flush=True)

    for head, shapes in (("gim_roma", cs.REFINER_SHAPES),
                         ("gim_dkm", cs.DKM_REFINER_SHAPES)):
        for shape in shapes:
            Bn, C, H, W = shape
            x = torch.randn(shape, device="cuda", generator=g)
            _, f = cs.refiner_block_params(C, C, torch.float32, g)
            timed(f"K2 {shape}", refiner, 0,
                  lambda: refiner.fused_dw_block(x, *f),
                  refiner.fused_dw_block_plain(x, *f),
                  cs.k2_f32_bounds(Bn, C, C, H, W)[0], cs.HIDDEN_BLOCKS,
                  f"{head} K2")
            del x
    for (G, N, D), n in cs.FLASH_SHAPES:
        t = torch.randn(2, N, 3, G // 2, D, device="cuda", generator=g)
        t[:, :, 0] *= 2.0
        q, k, v = t.permute(2, 0, 3, 1, 4).unbind(0)
        timed(f"K3 {(2, G // 2, N, D)}", flash, 1,
              lambda: flash.flash_sdpa(q, k, v),
              flash.flash_sdpa_plain(q, k, v), cs.k3_f32_bounds(G, N, D)[0],
              n, "gim_roma K3")
    for name, tot in totals.items():
        print(f"{name}: " + ", ".join(
            f"{what} {ms:.3f} ms a call ({ms / floors[what]:.2f}x floor "
            f"{floors[what]:.3f})" for what, ms in tot.items())
              + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
