"""The yardstick's counts by hand at a tiny shape, and a kernel's roofline
read the same whichever route served the call."""

import importlib.util

import pytest

from benchmark import harness, yardstick
from benchmark.trace import Span

B, T, H, V = 2, 3, 4, 5


def test_peaks():
    assert yardstick.PEAK_FLOPS["float32"] == pytest.approx(165e12)
    assert yardstick.HBM_BYTES_PER_S == 3.35e12


def test_fused_s2vt_counts():
    fwd = yardstick.fused_s2vt_fwd(B, T, H, "float32")
    # 3 products [B, H] x [H, 4H] a step; x1, x2, W1hh, W2v, W2hh read;
    # g1, g2, c1, c2 and six finals written, all float32.
    assert fwd.flops == 2 * T * B * 3 * 4 * H * H == 2304
    assert fwd.nbytes == 4 * (2 * T * B * 16 + 3 * 16 * H + 2 * T * B * 16 + 2 * T * B * H
                              + 6 * B * H) == 4 * (192 + 192 + 192 + 48 + 48)
    bwd = yardstick.fused_s2vt_bwd(B, T, H, "float32")
    assert bwd.flops == 2304
    assert bwd.nbytes == 4 * (2 * T * B * 16 + 3 * T * B * H + 3 * 16 * H + 2 * T * B * 16)


def test_gru_and_argmax_counts():
    fwd = yardstick.gru_seq_fwd(B, T, H, "float32")
    assert fwd.flops == 2 * T * B * 12 * H == 576
    assert fwd.nbytes == 4 * (T * B * 12 + 48 + 12 + B * H + T * B * 12 + 2 * T * B * H + B * H)
    bwd = yardstick.gru_seq_bwd(B, T, H, "float32")
    assert bwd.flops == 576
    assert bwd.nbytes == 4 * (T * B * 12 + 3 * T * B * H + 48 + B * H + T * B * 12 + T * B * H
                              + B * H)
    am = yardstick.argmax_linear(B, H, V, "float32")
    assert am.flops == 2 * B * H * V == 80
    assert am.nbytes == 4 * B * H + 4 * V * H + 4 * V + 8 * B
    assert am.bound_s("float32") == max(80 / 165e12, am.nbytes / 3.35e12)


def test_model_flops_by_hand():
    cfg = {"rnn_type": "lstm", "length": 2, "feat_dim": 3, "dim_hidden": 2, "dim_embed": 1,
           "vocab_size": 7}
    # L=2, T=3, G=8: feat 2*3*2; vid 3*(2*8+2*8); word 3*((1+2)*8+2*8); out 1*2*7.
    fwd = 2 * B * (12 + 96 + 120 + 14)
    assert yardstick.s2vt_forward_flops(cfg, B) == fwd
    assert yardstick.s2vt_train_step_flops(cfg, B) == 3 * fwd - 2 * B * 12
    # greedy: feat; vid over 3 steps; word over 2 encode steps; 1 decode step
    # with the out-projection.
    word = (1 + 2) * 8 + 2 * 8
    assert yardstick.s2vt_greedy_flops(cfg, B) == 2 * B * (12 + 3 * 32 + 2 * word + word + 14)
    gru = dict(cfg, rnn_type="gru")
    assert yardstick.s2vt_forward_flops(gru, B) == 2 * B * (12 + 3 * 24 + 3 * (3 * 6 + 12) + 14)


def _span(kernel_names):
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.traced_span", "ts": 0,
               "dur": 20000, "tid": 1}]
    for k, name in enumerate(kernel_names):
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": 10 + 3000 * k,
                       "dur": 2000})
    return Span(events)


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, harness.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("metric,loop,names", [
    ("fused_s2vt_fwd_roofline.train", "train",
     ("void (anonymous namespace)::s2vt_fused_fwd_kernel<float>(...)",
      "void (anonymous namespace)::mma_route::s2vt_fused_fwd_kernel_mma<false, 4>(...)")),
    ("gru_seq_fwd_roofline.train", "train",
     ("void gru_seq_fwd_kernel<float>(...)", "void gru_seq_fwd_kernel_mma<4>(...)")),
    ("gru_seq_bwd_roofline.train", "train",
     ("void gru_seq_bwd_kernel(...)", "void gru_seq_bwd_kernel_mma<16>(...)")),
    ("argmax_linear_roofline.caption", "caption",
     ("void (anonymous namespace)::argmax_linear_kernel(...)",
      "void (anonymous namespace)::argmax_linear_kernel_mma<float, 2>(...)")),
])
def test_roofline_same_whichever_route(metric, loop, names):
    cfg = {"length": 80, "dim_hidden": 512, "vocab_size": 10240, "dtype": "float32"}
    values = []
    for name in names:
        ctx = {"loop": loop, "cfg": cfg, "batch": 16, "device_type": "cuda",
               "span": _span([name, name, "other_kernel"])}
        values.append(_reader(metric)(ctx))
    assert values[0] == values[1] and 0 < values[0] < 100


def test_roofline_silent_without_its_kernel():
    ctx = {"loop": "train", "cfg": {"length": 80, "dim_hidden": 512, "dtype": "float32"},
           "batch": 16, "device_type": "cuda", "span": _span(["other_kernel"])}
    assert _reader("fused_s2vt_fwd_roofline.train")(ctx) is None
