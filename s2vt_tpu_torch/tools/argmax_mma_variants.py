"""What the shape of the out-projection-and-argmax kernel's tensor-core
route buys.

    python -m s2vt_tpu_torch.tools.argmax_mma_variants [--reps 100]

Builds ``csrc/argmax_linear.cu`` as it is and in variants that each change
one constant of its "mma" route, checks each (but the ``*_only`` ones)
against the
plain version on exact-tie integer inputs at B = 16 and 96 in both modes,
and prints for each the ``ptxas`` registers and spills of its mma kernels
and its device time (``torch.profiler``, the mean of ``--reps`` calls) at
V = 10240, H = 512, B in {16, 96}, float32 and bf16 (W read as bf16), and
at V = 205 (the serving corpus's vocab), B = 16, float32. Beside them: the
device time of one ``torch.amax`` over the float32 and the bf16 W, a
kernel that reads W once and does nothing else. Variants:

- ``stages_3`` / ``stages_8``: a ring of 3 (8) stages in place of 6 for
  one m16 tile of rows per block (3 stays for four, 4 with 8);
- ``warps_4`` / ``warps_8``: 4 or 8 column warps per block (64 or 128
  vocab columns, each block reading h once for them) in both modes, where
  bf16 takes 8 and float32 4;
- ``split_1`` / ``split_2``: each step's k slices shared by 1 or 2 warps
  per column warp at every B, where one m16 tile of rows takes 2 and four
  take 1;
- ``mi8``: 128 rows of h per block past B = 16 (one row tile at B = 96)
  in place of 64;
- ``step_256``: 256 bytes of each W row per step in place of 128;
- ``copy_only``: the ring fills and drains with no products; ``compute_only``:
  the products run on whatever the ring holds, with no copies (their tokens
  are not the function's: they time one half each).

Needs a card and ``nvcc``; builds into ``build/argmax_variants/`` at the
root of the checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.fused_decode import argmax_linear_reference
from s2vt_tpu_torch.tools import _variants

OUT_DIR = _build.BUILD_DIR.parent / "argmax_variants"
H = 512
SHAPES = ((16, 10240, False), (16, 10240, True), (96, 10240, False), (96, 10240, True),
          (16, 205, False))                                 # (B, V, bf16)

_STAGES = "static constexpr int kStages = MI == 1 ? 6 : 3;"
_STEP = "constexpr int kWRowBytes = 128;"
_WARPS = "static constexpr int kWarpsN = kES == 2 ? 8 : 4;"
_MI4 = "return launch_mma<T, 4>("
_PRODUCTS = "for (int kq = 0; kq < G::kSlices; ++kq) {"
_NO_PRODUCTS = "for (int kq = 0; kq < 0; ++kq) {"
_SPLIT = "static constexpr int kSplitK = MI == 1 ? 2 : 1;"
_COPIES = "auto load_stage = [&](int step, int slot) {"
_NO_COPIES = "auto load_stage = [&](int step, int slot) { return;"


def kernel_source() -> str:
    """The kernel's source with the shared headers written in place."""
    return _variants.source_with_headers("argmax_linear")


def variants(src: str) -> dict:
    """{name: source}: the kernel as it is ("as_built") and with one constant
    of its mma route changed each, found by exact text."""
    sub = _variants.replace_once
    return {"as_built": src,
            "stages_3": sub(src, (_STAGES, "static constexpr int kStages = 3;")),
            "stages_8": sub(src, (_STAGES, "static constexpr int kStages = MI == 1 ? 8 : 4;")),
            "warps_4": sub(src, (_WARPS, "static constexpr int kWarpsN = 4;")),
            "warps_8": sub(src, (_WARPS, "static constexpr int kWarpsN = 8;")),
            "split_1": sub(src, (_SPLIT, "static constexpr int kSplitK = 1;")),
            "split_2": sub(src, (_SPLIT, "static constexpr int kSplitK = 2;")),
            "mi8": sub(src, (_MI4, "return launch_mma<T, 8>(")),
            "step_256": sub(src, (_STEP, "constexpr int kWRowBytes = 256;")),
            "copy_only": sub(src, (_PRODUCTS, _NO_PRODUCTS)),
            "compute_only": sub(src, (_COPIES, _NO_COPIES))}


def build(sources: dict) -> dict:
    """{name: (loaded library, nvcc's report)}, all built together."""
    libs = _variants.build(sources, OUT_DIR)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        lib.argmax_linear_mma.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.argmax_linear_mma.restype = ci
        lib.argmax_linear_mma_vocab_tiles.argtypes = [ci, ci]
        lib.argmax_linear_mma_vocab_tiles.restype = ci
    return libs


def ptxas_mma(report: str) -> str:
    return "; ".join(f"{name}: {regs} registers, {stores}/{loads} bytes spilled"
                     for name, regs, stores, loads in _build.ptxas_entries(report)
                     if name.startswith("argmax_linear_kernel_mma"))


class Call:
    """One variant's launch on fixed inputs, its scratch made once."""

    def __init__(self, lib, h, w, b, bf16: bool):
        B, V = h.shape[0], w.shape[0]
        tiles = lib.argmax_linear_mma_vocab_tiles(V, int(bf16))
        self.lib, self.bf16 = lib, bf16
        self.tensors = (h, w.to(torch.bfloat16) if bf16 else w, b,
                        torch.empty(B, dtype=torch.int64, device=h.device),
                        torch.empty(tiles, B, device=h.device),
                        torch.empty(tiles, B, dtype=torch.int32, device=h.device),
                        torch.zeros(64, dtype=torch.int32, device=h.device))
        self.ints = (B, h.shape[1], V, V, int(bf16))

    def __call__(self):
        _build.launch(self.lib, "argmax_linear_mma", "argmax_linear_mma", self.tensors,
                      self.ints)
        return self.tensors[3]


def device_ms(fn, reps: int) -> float:
    """Device time of one call: the card's own time in the kernels it runs,
    summed by torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100, help="calls per timed shape")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    libs = build(variants(kernel_source()))
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = [[torch.randint(lo, hi, shape, device=dev, generator=gen).float()
               for lo, hi, shape in ((-3, 4, (B, H)), (-2, 3, (10240, H)), (-2, 3, (10240,)))]
              for B in (16, 96)]
    timed = {}
    for B, V, bf16 in SHAPES:
        timed[(B, V, bf16)] = (torch.randn(B, H, device=dev, generator=gen),
                               0.05 * torch.randn(V, H, device=dev, generator=gen),
                               torch.randn(V, device=dev, generator=gen))
    w = timed[(16, 10240, False)][1]
    for dt in (torch.float32, torch.bfloat16):
        wd = w.to(dt)
        print(f"argmax_mma read W once (torch.amax, {str(dt)[6:]}, V=10240, H={H}): "
              f"{device_ms(lambda: torch.amax(wd), args.reps):.4f} ms [{card}]", flush=True)
    for name, (lib, report) in libs.items():
        ok = "not checked"
        try:
            if not name.endswith("_only"):
                ok = "tokens equal" if all(
                    torch.equal(Call(lib, *c, bf16)(), argmax_linear_reference(*c, None, bf16))
                    for c in checks for bf16 in (False, True)) else "TOKENS DIFFER"
            times = ", ".join(
                f"B={B} V={V} {'bf16' if bf16 else 'float32'} "
                f"{device_ms(Call(lib, *timed[(B, V, bf16)], bf16), args.reps):.4f} ms"
                for B, V, bf16 in SHAPES)
        except RuntimeError as e:      # e.g. more shared memory than a block may have
            times = f"not run: {e}"
        print(f"argmax_mma variant {name}: {ok} (exact-tie inputs, B=16 and 96, both modes); "
              f"ptxas {ptxas_mma(report)}; device time {times} [{card}]", flush=True)


if __name__ == "__main__":
    main()
