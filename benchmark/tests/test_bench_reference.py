"""The plain reference against the program at a tiny size on the CPU: the
teacher-forced logits, the loss and its gradients, AdamW's update and the
greedy decode. The reference itself imports nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import s2vt as ref
from benchmark.tests.tiny import tiny_files

B = 3


def _program_model(cfg, use_pallas):
    from s2vt_tpu_torch.config import Opt
    from s2vt_tpu_torch.training.loop import build_model
    opt = Opt(train_length=cfg["length"], dim_hidden=cfg["dim_hidden"],
              dim_embed=cfg["dim_embed"], feat_dim=cfg["feat_dim"], rnn_type=cfg["rnn_type"],
              use_pallas=use_pallas, sos_ix=2, eos_ix=3)
    model = build_model(opt, cfg["vocab_size"], valid_vocab=cfg["vocab_size"])
    model.load_state_dict(weights.make_weights(cfg, 7, "cpu"))
    return model


def _batch(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    L = cfg["length"]
    feats = torch.randn(B, L, cfg["feat_dim"], generator=g).clamp(min=0)
    labels = torch.randint(4, cfg["vocab_size"], (B, L), generator=g)
    mask = (torch.arange(L)[None] < torch.tensor([[L], [3], [4]])).float()
    return feats, labels * mask.long(), mask, torch.tensor([1.0, 1.0, 0.0])


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_program(rnn_type, use_pallas):
    from s2vt_tpu_torch.training.loop import batch_loss
    cfg = dict(tiny_files("lstm.train.b16")[1], rnn_type=rnn_type)
    model = _program_model(cfg, use_pallas)
    feats, labels, mask, valid = _batch(cfg)
    logits = model(feats, labels[:, :-1], mode="train", deterministic=True)
    loss = batch_loss(logits, labels, mask, valid)
    grads = dict(zip([k for k, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))

    params = {k: v.requires_grad_(True) for k, v in weights.make_weights(cfg, 7, "cpu").items()}
    want = ref.train_logits(params, feats, labels, cfg, "float32")
    want_loss = ref.masked_ce(want, labels, mask, valid)
    want_grads = dict(zip(params, torch.autograd.grad(want_loss, list(params.values()))))
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    assert set(grads) == set(want_grads)
    for k in grads:
        torch.testing.assert_close(grads[k], want_grads[k], rtol=1e-4, atol=1e-7, msg=k)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt_t = torch.optim.AdamW(list(theirs.values()), lr=1e-2, weight_decay=0.1)
    opt_r = ref.AdamW(params, 1e-2, 0.1)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
        for k, p in theirs.items():
            p.grad = grads[k].clone()
        opt_t.step()
        opt_r.step(params, grads)
    for k in params:
        torch.testing.assert_close(params[k], theirs[k].detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_matches_program(rnn_type, use_pallas):
    cfg = dict(tiny_files("lstm.caption")[1], rnn_type=rnn_type, sos_ix=2)
    model = _program_model(cfg, use_pallas).eval()
    feats = _batch(cfg)[0]
    tokens = model.greedy(feats)
    params = weights.make_weights(cfg, 7, "cpu")
    assert ref.decode_gaps(params, feats, tokens, cfg) <= 1e-6
    # the reference's own greedy choice, fed back, is the program's
    prev_steps = ref.decode_logits(params, feats, tokens, cfg, "float32")
    own = torch.stack([lg.argmax(dim=-1) for lg in prev_steps], dim=1)
    assert torch.equal(own, tokens.long())
    # a token altered at one step shows as a gap
    bad = tokens.clone()
    bad[0, 2] = (bad[0, 2] + 1) % cfg["vocab_size"]
    assert ref.decode_gaps(params, feats, bad, cfg) > 1e-4


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.14159, 1e-30])
    r = ref.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0            # a tie rounds to even
    assert r[2] == 1.0 + 2 * 2.0 ** -10
    bits = r.view(torch.int32).numpy()
    assert np.all(bits & 0x1FFF == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.s2vt, benchmark.weights, "
            "benchmark.yardstick, benchmark.compare; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('s2vt_tpu_torch', 's2vt_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
