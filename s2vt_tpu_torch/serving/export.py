"""Serving artifacts: the decode computation as an exported PyTorch program.

Counterpart of ``s2vt_tpu/serving/export.py``. A serving replica should not
need the model's Python definition: the whole captioner (feature
projection, both RNN chains, the greedy argmax loop or the batched beam
search) is captured once by ``torch.export`` as one program with its
weights, and replayed by ``ServingCaptioner`` without model code.

Artifact layout (one directory):
  decode.pt2     ``torch.export.save`` of fn(feats[B, L, F]) -> token ids
                 (int8 artifacts: fn(feats_i8, scale[B]), dequantised on the
                 device as the first operation; see ``quantize_feats``),
                 holding the weights
  manifest.json  shapes and dtypes, vocab map, special tokens, decode
                 config, the torch version and the device it was exported for

The program holds the port's kernels as ``torch.library`` operators
(``s2vt_tpu_torch::fused_s2vt_fwd``, ``lstm_seq_fwd``, ``gru_seq_fwd``,
``argmax_linear``) when the model was built with ``use_pallas``: replayed on
a card each launches its hand-written kernel, on the CPU its plain version.
The loader imports those op registrations (``s2vt_tpu_torch.ops``) and
nothing of ``s2vt_tpu_torch.models``.

Tensors that the decode creates (the zero states, the ``<sos>`` column) are
made on the device the program was exported for, so an artifact replays on
that device (``manifest["device"]``). The exported beam search runs all
``max_beam_depth`` rounds (``beam_search`` under ``torch.export``): its
stopping test is a host sync that a program cannot hold, and the rounds
after every beam has finished leave the result unchanged.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from s2vt_tpu_torch.data.corpus import ids_to_sentence

PROGRAM_FILE = "decode.pt2"
MANIFEST_FILE = "manifest.json"
QUANT_LEVELS = 127
FEATS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8}


def quantize_feats(feats: np.ndarray, levels: int = QUANT_LEVELS):
    """Per-clip symmetric absmax int8 quantization of [B, L, F] features
    (``s2vt_tpu/serving/export.py::quantize_feats``, bit for bit).

    Returns ``(q_int8, scale_f32[B])``; the artifact dequantises on the
    device as ``q.float() * scale[:, None, None]``. The largest error is
    ``scale / 2`` = absmax/254 per clip: a lossy opt-in that quarters the
    upload of float32 features. An all-zero clip gets scale 1.0. The clip to
    +-levels is not redundant: float32 division may land absmax/scale just
    above ``levels``, and int8 would wrap 128 to -128."""
    feats = np.asarray(feats, dtype=np.float32)
    absmax = np.maximum(feats.max(axis=(1, 2)), -feats.min(axis=(1, 2)))
    scale = np.where(absmax > 0, absmax / levels, 1.0).astype(np.float32)
    out = np.empty(feats.shape, np.float32)
    np.divide(feats, scale[:, None, None], out=out)
    np.rint(out, out=out)
    np.clip(out, -levels, levels, out=out)
    return out.astype(np.int8), scale


class _Decode(torch.nn.Module):
    """What the artifact runs: float features -> greedy ids [B, L-1] (S2VT) or
    [B, L] (attention baseline), or the best beam's ids [B, D+1] (its
    position 0 is ``<sos>``)."""

    def __init__(self, model, mode: str, beam_width: int, max_beam_depth: int,
                 beam_score_mode: str):
        super().__init__()
        self.model = model
        self.mode = mode
        self.beam_width, self.max_beam_depth = beam_width, max_beam_depth
        self.beam_score_mode = beam_score_mode

    def forward(self, feats):
        feats = feats.float()
        if self.mode == "greedy":
            return self.model.greedy(feats)
        res = self.model.beam(feats, self.beam_width, self.max_beam_depth,
                              score_mode=self.beam_score_mode)
        return res.tokens[:, 0, :]


class _DequantDecode(torch.nn.Module):
    """int8 features and their per-clip scale, dequantised on the device,
    then the float decode."""

    def __init__(self, decode: _Decode):
        super().__init__()
        self.decode = decode

    def forward(self, q, scale):
        return self.decode(q.float() * scale[:, None, None])


def export_captioner(model, ix2word: Dict[int, str], specials: Dict[str, int],
                     batch_size: Optional[int], out_dir: str, mode: str = "greedy",
                     beam_width: int = 3, max_beam_depth: int = 30,
                     beam_score_mode: str = "cumulative",
                     feats_dtype: str = "float32") -> pathlib.Path:
    """Export ``model`` (S2VT or the attention baseline, weights loaded, on
    the device the artifact is for) to ``out_dir``.

    The program maps features [batch_size, L, F] in ``feats_dtype`` to greedy
    token ids (``mode='greedy'``) or the best beam's ids [B, max_beam_depth+1]
    (``mode='beam'``). ``batch_size=None`` exports a dynamic batch dimension:
    one artifact serves any batch size. A model built with ``use_pallas``
    exports its kernel route (the operators), the plain route otherwise."""
    if mode not in ("greedy", "beam"):
        raise ValueError(f"mode {mode!r} not supported (greedy|beam)")
    if feats_dtype not in FEATS_DTYPES:
        raise ValueError(f"feats_dtype must be one of {sorted(FEATS_DTYPES)}, got "
                         f"{feats_dtype!r}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model = model.eval()
    L = model.length
    F = getattr(model, "feat_dim", None) or model.dim_feat
    device = next(model.parameters()).device
    fn = _Decode(model, mode, beam_width, max_beam_depth, beam_score_mode)
    example_b = batch_size if batch_size is not None else 2
    quantized = feats_dtype == "int8"
    feats = torch.zeros(example_b, L, F, dtype=FEATS_DTYPES[feats_dtype], device=device)
    args = (feats,)
    if quantized:
        fn = _DequantDecode(fn)
        args = (feats, torch.ones(example_b, dtype=torch.float32, device=device))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1, max=1 << 16)
        dynamic = tuple({0: batch} for _ in args)
    with torch.no_grad():
        program = torch.export.export(fn, args, dynamic_shapes=dynamic, strict=False)
    torch.export.save(program, str(out / PROGRAM_FILE))
    manifest = {
        "mode": mode,
        "batch_size": batch_size,
        "length": L,
        "feat_dim": F,
        "feats_dtype": feats_dtype,
        "ix2word": {str(k): v for k, v in ix2word.items()},
        "specials": dict(specials),
        "beam": {"width": beam_width, "max_depth": max_beam_depth,
                 "score_mode": beam_score_mode},
        "torch_version": torch.__version__,
        "device": device.type,
    }
    if quantized:
        manifest["quant"] = {"strategy": "per_clip_absmax", "levels": QUANT_LEVELS}
    (out / MANIFEST_FILE).write_text(json.dumps(manifest))
    return out


def _register_ops() -> None:
    """Import the port's operator registrations, which the program's nodes
    name; the model code is not needed."""
    import s2vt_tpu_torch.ops.fused_decode  # noqa: F401
    import s2vt_tpu_torch.ops.fused_gru  # noqa: F401
    import s2vt_tpu_torch.ops.fused_rnn  # noqa: F401
    import s2vt_tpu_torch.ops.fused_s2vt  # noqa: F401


class ServingCaptioner:
    """Loads an exported artifact and captions feature batches: no model
    code, no re-trace; one call of the loaded program per batch."""

    def __init__(self, artifact_dir: str):
        root = pathlib.Path(artifact_dir)
        self.manifest = json.loads((root / MANIFEST_FILE).read_text())
        self.device = torch.device(self.manifest["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the artifact was exported for a CUDA device and none is "
                               "available")
        _register_ops()
        self._program = torch.export.load(str(root / PROGRAM_FILE))
        self._call = self._program.module()
        self.ix2word = {int(k): v for k, v in self.manifest["ix2word"].items()}
        sp = self.manifest["specials"]
        self.eos_ix, self.pad_ix, self.sos_ix = sp["eos_ix"], sp["pad_ix"], sp["sos_ix"]
        self.batch_size = self.manifest["batch_size"]
        self.quantized = self.manifest["feats_dtype"] == "int8"

    def _request_arrays(self, feats: np.ndarray) -> tuple:
        """The request payload as uploaded: the manifest-dtype features, or
        for int8 artifacts the per-clip (int8, scale) pair."""
        if self.quantized:
            if np.asarray(feats).dtype == np.int8:
                raise TypeError("int8 artifacts quantize float features internally; pass "
                                "the float array")
            q, scale = quantize_feats(feats)
            return torch.from_numpy(q), torch.from_numpy(scale)
        x = torch.from_numpy(np.array(feats, dtype=np.float32))
        return (x.to(FEATS_DTYPES[self.manifest["feats_dtype"]]),)

    def _run(self, arrays) -> torch.Tensor:
        with torch.no_grad():
            return self._call(*(a.to(self.device) for a in arrays))

    def decode_tokens(self, feats: np.ndarray) -> np.ndarray:
        """Raw token ids for one batch of the exported shape (float input,
        cast or quantized to the artifact's payload dtype here)."""
        return self._run(self._request_arrays(feats)).cpu().numpy()

    def decode_tokens_timed(self, feats: np.ndarray):
        """One request with its phases: (tokens, {h2d_ms, exec_ms, d2h_ms,
        device_ms}). On a card each phase is timed with CUDA events on the
        current stream: the upload, the program's call and the token fetch;
        ``device_ms`` is exec + fetch, the request's turnaround after the
        upload. On the CPU the phases are host-clock times."""
        arrays = self._request_arrays(feats)      # host cast / quantize, untimed
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            devs = [a.to(self.device) for a in arrays]
            t1 = time.perf_counter()
            with torch.no_grad():
                out = self._call(*devs)
            t2 = time.perf_counter()
            toks = out.numpy()
            t3 = time.perf_counter()
            h2d, ex, d2h = (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3
        else:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            pinned = [a.pin_memory() for a in arrays]
            torch.cuda.synchronize(self.device)
            ev[0].record()
            devs = [a.to(self.device, non_blocking=True) for a in pinned]
            ev[1].record()
            with torch.no_grad():
                out = self._call(*devs)
            ev[2].record()
            toks = out.cpu()
            ev[3].record()
            torch.cuda.synchronize(self.device)
            h2d, ex, d2h = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                            ev[2].elapsed_time(ev[3]))
            toks = toks.numpy()
        return toks, {"h2d_ms": h2d, "exec_ms": ex, "d2h_ms": d2h, "device_ms": ex + d2h}

    def caption(self, feats: np.ndarray) -> List[str]:
        """Caption a batch of clips. A fixed-batch artifact zero-pads a
        smaller batch to its size; a dynamic-batch artifact (``batch_size``
        null) takes any batch as it is."""
        feats = np.asarray(feats)
        n = feats.shape[0]
        if self.batch_size is not None:
            if n > self.batch_size:
                raise ValueError(f"batch {n} exceeds exported size {self.batch_size}")
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n,) + feats.shape[1:], feats.dtype)
                feats = np.concatenate([feats, pad], axis=0)
        toks = self.decode_tokens(feats)
        # a leading <sos> (always there on the beam path's slot 0) is stripped
        return [ids_to_sentence(toks[i], self.ix2word, self.eos_ix, sos_ix=self.sos_ix,
                                pad_ix=self.pad_ix) for i in range(n)]
