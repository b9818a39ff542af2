"""What each design choice of the fused conv kernel's float32 tensor-core
route buys.

    python -m s2vt_tpu_torch.tools.conv_mma_variants [--n 80]

Builds ``csrc/conv3x3_bn_relu.cu`` as it is and in variants that each undo
one choice of its float32 "mma" route, and prints for each: the ``ptxas``
registers and spills of its float32 mma kernel, its largest error against
the plain version at VGG16's (28 x 28, 512 -> 512) layer (N = 2; the bound
is 1e-4 + 1e-4*|want|), and its time over VGG16's 12 mma layers at N frames
in float32 (the source as it is also in bf16). Variants:

- ``one_accumulator``: every TF32 pass adds into the running sum, with no
  per-slice partial (the tensor cores truncate as they accumulate);
- ``cvt_rounding``: big and small each rounded by ``cvt.rna.tf32.f32``;
- ``rounded_small``: small rounded to TF32 by integer operations;
- ``warp_64x32``: float32 on 64 x 32 warp tiles (4-warp blocks) under the
  same 128-register cap; ``warp_64x32_uncapped`` without the cap.

The variants are made from ``kernel_source()``: the source with the shared
headers it includes (``csrc/*.cuh``, where the TF32 split lives) written in
place. Needs a card and ``nvcc``; builds into ``build/conv_variants/`` at
the root of the checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.fused_conv import conv3x3_bn_relu_reference
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "conv_variants"
# VGG16's layers on the mma route: (H = W, C, K)
MMA_LAYERS = ((224, 64, 64), (112, 64, 128), (112, 128, 128), (56, 128, 256), (56, 256, 256),
              (56, 256, 256), (28, 256, 512), (28, 512, 512), (28, 512, 512), (14, 512, 512),
              (14, 512, 512), (14, 512, 512))
CHECK = (2, 28, 28, 512, 512)

_PART = """            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(part, a_small, b_big[ni]);
            mma_tf32(part, a_big, b_small[ni]);
            mma_tf32(part, a_big, b_big[ni]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[j];
"""
_ONE_ACC = """            mma_tf32(acc[mi][ni], a_small, b_big[ni]);
            mma_tf32(acc[mi][ni], a_big, b_small[ni]);
            mma_tf32(acc[mi][ni], a_big, b_big[ni]);
"""
_RNA_INT = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
_RNA_CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));\n'
            "  return r;\n")
_SMALL = "  small = __float_as_uint(v - __uint_as_float(big));\n"
_SMALL_ROUNDED = "  small = tf32_rna(v - __uint_as_float(big));\n"
_MI = "static constexpr int kMI = kES == 2 ? 4 : 2;"
_BOUNDS = "__launch_bounds__(MmaTile<T, BN>::kThreads, MmaTile<T, BN>::kMinBlocks)"


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("conv3x3_bn_relu")


def variants(src: str) -> dict:
    """{name: source}: the kernel as it is ("as_built") and with one choice
    of its float32 route undone each, found by exact text."""
    sub = _variants.replace_once
    return {"as_built": src,
            "one_accumulator": sub(src, (_PART, _ONE_ACC)),
            "cvt_rounding": sub(src, (_RNA_INT, _RNA_CVT), (_SMALL, _SMALL_ROUNDED)),
            "rounded_small": sub(src, (_SMALL, _SMALL_ROUNDED)),
            "warp_64x32": sub(src, (_MI, "static constexpr int kMI = 4;")),
            "warp_64x32_uncapped": sub(src, (_MI, "static constexpr int kMI = 4;"),
                                       (_BOUNDS, "__launch_bounds__(MmaTile<T, BN>::kThreads)"))}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        lib.conv3x3_bn_relu_mma.argtypes = [vp] * 5 + [ci] * 7 + [vp]
        lib.conv3x3_bn_relu_mma.restype = ci
    return libs


def ptxas_f32(report: str) -> str:
    """Registers and spills of the float32 mma kernel in nvcc's report."""
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled (stores/loads)"
                     for name, regs, stores, loads in _build.ptxas_entries(report)
                     if name.startswith("conv3x3_bn_relu_kernel_mma<float"))


def inputs(n, hw, C, K, dev, gen):
    """chip_smoke.py's conv_inputs distribution."""
    x = torch.randn(n, hw, hw, C, device=dev, generator=gen)
    w = torch.randn(3, 3, C, K, device=dev, generator=gen) * math.sqrt(2.0 / (9 * C))
    scale = 1.0 + 0.3 * torch.randn(K, device=dev, generator=gen)
    shift = 0.1 * torch.randn(K, device=dev, generator=gen)
    return [x, w, scale, shift]


def run(lib, args, bf16: bool):
    dt = torch.bfloat16 if bf16 else torch.float32
    x, w = args[0].to(dt).contiguous(), args[1].to(dt).contiguous()
    N, H, W, C = x.shape
    K = w.shape[3]
    out = torch.empty(N, H, W, K, dtype=dt, device=x.device)
    _build.launch(lib, "conv3x3_bn_relu_mma", "conv3x3_bn_relu_mma", (x, w, *args[2:], out),
                  (N, H, W, C, K, int(bf16)))
    return out


def time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=80, help="frames per timed layer")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    libs = build(variants(kernel_source()))
    gen = torch.Generator(device=dev).manual_seed(0)
    check = inputs(CHECK[0], CHECK[1], CHECK[3], CHECK[4], dev, gen)
    want = conv3x3_bn_relu_reference(*check)
    layers = {False: [inputs(args.n, hw, C, K, dev, gen) for hw, C, K in MMA_LAYERS]}
    layers[True] = [[a[0].bfloat16(), a[1].bfloat16(), *a[2:]] for a in layers[False]]
    for name, (lib, report) in libs.items():
        diff = (run(lib, check, False) - want).abs()
        excess = (diff - 1e-4 * (1 + want.abs())).max().item()
        modes = (False, True) if name == "as_built" else (False,)
        totals = {bf16: sum(time_ms(lambda: run(lib, a, bf16)) for a in layers[bf16])
                  for bf16 in modes}
        print(f"conv_mma variant {name}: ptxas (float32 mma) {ptxas_f32(report)}; "
              f"max_abs_err {diff.max().item():.3e} at N={CHECK[0]} 28x28 512->512 float32 "
              f"(excess over 1e-4 + 1e-4*|want|: {excess:.3e}); 12 mma layers N={args.n}: "
              + ", ".join(f"{'bf16' if bf16 else 'float32'} {ms:.4f} ms"
                          for bf16, ms in totals.items()) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
