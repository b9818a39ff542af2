"""Where the attention-decoder kernel's time goes, phase by phase.

    python -m s2vt_tpu_torch.tools.att_decode_phases [--batches 16,96]

Builds variants of ``csrc/att_decode_fwd.cu`` with phases cut out of the
step loop and times each on the card at T = 79, L = 80, H = 512 (float32):
the differences give each phase's cost per step and that of the grid
barriers. The variants compute wrong results; they only time. Needs a card
and ``nvcc``; builds into ``build/phases/`` at the root of the checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from s2vt_tpu_torch.ops import _build
from s2vt_tpu_torch.ops.fused_att_decode import _layout

T, L, H = 79, 80, 512
OUT_DIR = _build.BUILD_DIR.parent / "phases"


def variants(src: str) -> dict:
    """{name: source}: the kernel with phases (A gates, B dw, C scores, D
    softmax and context) and grid barriers cut out, found by the source's
    phase comments and its four ``grid.sync()`` lines."""
    lines = src.splitlines(keepends=True)

    def at(marker: str) -> int:
        hits = [i for i, line in enumerate(lines) if marker in line]
        if len(hits) != 1:
            raise RuntimeError(f"marker {marker!r} found {len(hits)} times")
        return hits[0]

    syncs = [i for i, line in enumerate(lines) if "grid.sync();" in line]
    if len(syncs) != 4:
        raise RuntimeError(f"expected 4 grid.sync() lines, found {len(syncs)}")
    a = (at("// A: gates"), at("if (t + 1 == T) break;"))
    b, c, d = ((at("// B: dw"), syncs[1]), (at("// C: et"), syncs[2]),
               (at("// D: softmax"), syncs[3]))

    def cut(spans=(), drop=()):
        return "".join(line for i, line in enumerate(lines)
                       if i not in drop and not any(s <= i < e for s, e in spans))

    return {"full": cut(), "no_B": cut([b]), "no_C": cut([c]), "no_D": cut([d]),
            "A_4_barriers": cut([b, c, d]), "A_1_barrier": cut([b, c, d], syncs[1:]),
            "4_barriers": cut([a, b, c, d]), "1_barrier": cut([a, b, c, d], syncs[1:])}


def build(sources: dict) -> dict:
    """{name: loaded library}, one nvcc per variant, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT_DIR / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT_DIR / f"{name}.so"),
             str(OUT_DIR / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.att_decode_fwd.argtypes = [vp] * 11 + [ci] * 8 + [vp]
        lib.att_decode_fwd.restype = ci
        lib.s2vt_cuda_error_string.argtypes = [ci]
        lib.s2vt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 20) -> float:
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
    ap.add_argument("--batches", default="16,96")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    libs = build(variants((_build.CSRC / "att_decode_fwd.cu").read_text()))
    units, tile_rows = _layout(H, L, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B in (int(b) for b in args.batches.split(",")):
        shapes = ((T, B, 4 * H), (4 * H, 2 * H), (4 * H, H), (H, H), (H,), (H,), (B, L, H),
                  (B, L, 2 * H), (B, 2 * H))
        inputs = [0.1 * torch.randn(s, device=dev, generator=gen) for s in shapes]
        out = torch.empty(T, B, H, device=dev)
        scratch = torch.zeros(B * (4 * H + L), device=dev)
        for name, lib in libs.items():
            ms = time_ms(lambda: _build.launch(lib, "att_decode_fwd", name,
                                               (*inputs, out, scratch),
                                               (T, B, H, L, units, tile_rows, 0)))
            print(f"att_decode_fwd variant {name} B={B} T={T} L={L} H={H} float32: {ms:.4f} ms, "
                  f"{ms / T * 1e3:.2f} us per step [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
