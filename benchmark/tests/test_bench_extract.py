"""The extraction cell on the CPU: the plain VGG16-BN reference against the
program's ``vgg16_bn``, the yardstick's counts and the cell's readers on a
hand-made trace. (Its whole runs, sound, with a fault, and with the
control or a fault in the program's place, are cases of
``test_bench_faults.py`` and ``test_bench_control.py``.)"""

import subprocess
import sys

import pytest
import torch

from benchmark import harness, vgg_weights, yardstick, yardstick_cnn
from benchmark.loops import extract
from benchmark.reference import vgg16 as ref
from benchmark.tests import tiny
from benchmark.trace import Span

WORKLOAD = "vgg16.extract.n80"
# Both sides compute in float32 on the CPU, with sums in different orders
# (nine shifted products against one convolution): a frame's features agree
# to a few float32 rounding steps of its largest value.
CPU_GAP = 1e-5


def tiny_files() -> tuple:
    return tiny.tiny_files(WORKLOAD)


# --- the reference against the program -------------------------------------------------

def test_preprocess_matches_program():
    from s2vt_tpu_torch.extract.preprocess import preprocess_frames
    cfg = tiny_files()[1]
    for h, w in ((30, 40), (300, 400), (400, 300)):
        frames = torch.randint(0, 256, (2, h, w, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(h))
        got = preprocess_frames(frames, cfg["mean"], cfg["std"], cfg["input_size"])
        want = ref.preprocess(frames, cfg).permute(0, 2, 3, 1)
        # the program computes the filter's sample positions in float32, as
        # jax.image.resize does, the reference in float64: over 400 columns
        # their rounding moves a weight by up to 2.5e-5, a normalised pixel
        # (x / 255 - mean) / std by up to ~1e-4
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_features_match_program(use_pallas):
    from s2vt_tpu_torch.extract.pipeline import FeatureExtractor
    _, cfg, traffic, _ = tiny_files()
    extractor = FeatureExtractor(cfg["backbone"], use_pallas=use_pallas, device="cpu")
    params = vgg_weights.make_weights(cfg, 7, "cpu")
    extractor.model.load_state_dict(params)
    frames = vgg_weights.make_frames(dict(traffic, pool_clips=1, frames_per_clip=4), 7, "cpu")[0]
    got = torch.from_numpy(extractor(frames.numpy()))
    want = ref.features(params, frames, cfg)
    assert got.shape == want.shape == (4, cfg["feat_dim"])
    assert (want > 0).float().mean() > 0.1          # the seeded weights keep fc7 alive
    assert extract.feature_gap(got, want) <= CPU_GAP
    # one conv's BatchNorm left out, or TF32 operands, show as a gap
    assert extract.feature_gap(ref.features(params, frames, cfg, skip_bn=5), want) > 1e-2
    assert extract.feature_gap(ref.features(params, frames, cfg, "tf32"), want) > 1e-4


def test_feature_gap():
    want = torch.tensor([[1.0, 2.0], [0.5, 0.0], [4.0, 0.0]])
    got = want.clone()
    assert extract.feature_gap(got, want) == 0
    got[1, 0] += 0.02          # frame 1's max 0.5 is under the median frame's 2
    assert extract.feature_gap(got, want) == pytest.approx(0.01)
    got[2, 1] += 0.08          # frame 2's own max is 4
    assert extract.feature_gap(got, want) == pytest.approx(0.02)
    got[0, 0] = float("nan")
    assert extract.feature_gap(got, want) == float("inf")
    assert extract.feature_gap(got[:2], want) == float("inf")


def test_reference_and_loop_import_nothing_forbidden():
    code = ("import sys; import benchmark.reference.vgg16, benchmark.vgg_weights, "
            "benchmark.yardstick_cnn; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('s2vt_tpu_torch', 's2vt_tpu', 'jax', 'jaxlib', 'flax'))); "
            "import benchmark.loops.extract, benchmark.calibrate, "
            "s2vt_tpu_torch.extract.pipeline; from benchmark import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]


# --- the yardstick and the readers ----------------------------------------------------

def test_vgg16_counts():
    # torchvision's published 15.47 GMAC a 224 x 224 frame counts fc8 (4096 x
    # 1000) too, which the extractor drops
    macs = yardstick_cnn.vgg16_frame_flops(224) / 2
    assert abs(macs - 15.47e9) <= 0.01 * 15.47e9
    assert macs + 4096 * 1000 == pytest.approx(15.47e9, rel=1e-3)
    shapes = yardstick_cnn.vgg16_conv_shapes(224)
    assert len(shapes) == 13 and shapes[0] == (224, 224, 3, 64) and shapes[-1] == (14, 14, 512, 512)
    w = yardstick_cnn.conv3x3_bn_relu(2, 3, 4, 5, 6, "float32")
    assert w.flops == 2 * 2 * 3 * 4 * 9 * 5 * 6
    assert w.nbytes == 4 * (2 * 3 * 4 * 5 + 9 * 5 * 6 + 2 * 6 + 2 * 3 * 4 * 6)
    assert yardstick_cnn.conv3x3_bn_relu(2, 3, 4, 5, 6, "bfloat16").nbytes == \
        2 * (2 * 3 * 4 * 5 + 9 * 5 * 6 + 2 * 3 * 4 * 6) + 4 * 2 * 6


def _span(kernels, lo=0, hi=30000):
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.traced_span", "ts": lo,
               "dur": hi - lo, "tid": 1}]
    for k, name in enumerate(kernels):
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": 10 + 1000 * k,
                       "dur": 500})
    return Span(events)


def _ctx(span, launches, **kw):
    cfg = tiny_files()[1]
    ctx = {"loop": "extract", "cfg": cfg, "device_type": "cuda", "span": span,
           "span_units": 2, "frames": 320, "window_s": 10.0, "window_units": 40,
           "launches": {"conv3x3_bn_relu": launches}}
    ctx.update(kw)
    return ctx


def test_readers_on_a_hand_made_trace():
    names = (["void (anonymous namespace)::conv3x3_bn_relu_kernel<float>(...)"]
             + ["void (anonymous namespace)::conv3x3_bn_relu_kernel_mma<float, 64>(...)"] * 12)
    span = _span(names * 2 + ["other_kernel"])
    ctx = _ctx(span, 26)
    bound = sum(w.bound_s("float32") for w in yardstick_cnn.vgg16_conv_works(320, "float32"))
    assert harness.read_metric("conv3x3_bn_relu_roofline.extract", ctx) == pytest.approx(
        100 * bound * 2 / (26 * 500e-6))
    assert harness.read_metric("launches_per_request.extract", ctx) == pytest.approx(27 / 2)
    flops = yardstick_cnn.vgg16_frame_flops(224) * 320 * 40
    assert harness.read_metric("mfu.extract", ctx) == pytest.approx(
        100 * flops / 10.0 / yardstick.PEAK_FLOPS["float32"])
    # 27 records of 0.5 ms, 13.5 ms busy over 2 requests, against 0.25 s a request
    assert harness.read_metric("device_idle.extract", ctx) == pytest.approx(
        100 * (1 - 13.5e-3 / 2 / 0.25))


@pytest.mark.parametrize("name", ["conv3x3_bn_relu_roofline.extract", "mfu.extract",
                                  "device_idle.extract", "launches_per_request.extract"])
def test_readers_none_where_nothing_to_read(name):
    span = _span(["void conv3x3_bn_relu_kernel<float>(...)"] * 13)
    assert harness.read_metric(name, _ctx(span, 13, device_type="cpu", loop="train")) is None
    assert harness.read_metric(name, _ctx(None, 13, loop="caption")) is None
    if name == "conv3x3_bn_relu_roofline.extract":
        assert harness.read_metric(name, _ctx(span, 12)) is None     # a record dropped
        assert harness.read_metric(name, _ctx(_span(["other"]), 0)) is None
