"""The benchmark's yardstick: operations and bytes per logical operation, and
the card's peaks.

Work is counted from the shapes of an operation as the model's equations
define it, never from the route or kernel that serves it: each input byte
is read once, each output byte written once, and a product of an [M, K] by
a [K, N] matrix is 2 M K N operations. A later change that moves an
operation to another route or kernel is read against the same work.

One peak per stated dtype. A float32 configuration is held to the fastest
way an H100 reaches float32 accuracy: three TF32 passes on the tensor
cores, 495 / 3 = 165 TFLOP/s. HBM moves 3.35 TB/s. Both are NVIDIA's data
sheet figures for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

PEAK_FLOPS: Dict[str, float] = {"float32": 495e12 / 3, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


class Work(NamedTuple):
    flops: float
    nbytes: float

    def bound_s(self, dtype: str) -> float:
        """The least time the card could take: the larger of operations over
        the dtype's peak and bytes over HBM's rate."""
        return max(self.flops / PEAK_FLOPS[dtype], self.nbytes / HBM_BYTES_PER_S)


def fused_s2vt_fwd(B: int, T: int, H: int, dtype: str) -> Work:
    """#1, both LSTM chains of 1-layer S2VT over T steps: reads x1, x2
    [T, B, 4H] and W1hh, W2v, W2hh [4H, H]; writes the gates and c of both
    chains ([T, B, 4H], [T, B, H], float32 c) and six [B, H] finals; the
    recurrent products h1 W1hh^T, h1 W2v^T, h2 W2hh^T each step."""
    e, G = ITEMSIZE[dtype], 4 * H
    nbytes = (2 * T * B * G * e + 3 * G * H * e
              + 2 * T * B * G * e + 2 * T * B * H * 4 + 6 * B * H * 4)
    return Work(2 * T * B * 3 * G * H, nbytes)


def fused_s2vt_bwd(B: int, T: int, H: int, dtype: str) -> Work:
    """#2: reads g1, g2 [T, B, 4H], c1, c2, dout2 [T, B, H] and the three
    [4H, H] weights; writes dxp1, dxp2 [T, B, 4H]; the products of the gate
    gradients with the three weights each step."""
    e, G = ITEMSIZE[dtype], 4 * H
    nbytes = 2 * T * B * G * e + 3 * T * B * H * 4 + 3 * G * H * e + 2 * T * B * G * e
    return Work(2 * T * B * 3 * G * H, nbytes)


def gru_seq_fwd(B: int, T: int, H: int, dtype: str) -> Work:
    """#5, one GRU layer over T steps: reads x_proj [T, B, 3H], W_hh [3H, H],
    b_hh [3H], h0 [B, H]; writes the h and gh_n sequences [T, B, H], the
    gates [T, B, 3H] and hT; the product h W_hh^T each step."""
    G = 3 * H
    nbytes = 4 * (T * B * G + G * H + G + B * H
                  + T * B * G + 2 * T * B * H + B * H)
    return Work(2 * T * B * G * H, nbytes)


def gru_seq_bwd(B: int, T: int, H: int, dtype: str) -> Work:
    """#6: reads the gates [T, B, 3H], gh_n, h_prev, dout [T, B, H], W_hh and
    dhT; writes dxp [T, B, 3H], dghn [T, B, H] and dh0; the product of the
    gate gradients with W_hh each step."""
    G = 3 * H
    nbytes = 4 * (T * B * G + 3 * T * B * H + G * H + B * H
                  + T * B * G + T * B * H + B * H)
    return Work(2 * T * B * G * H, nbytes)


def argmax_linear(B: int, H: int, V: int, dtype: str) -> Work:
    """#8, one greedy pick: reads h [B, H] (float32), W [V, H], b [V];
    writes B int64 ids; the product h W^T."""
    nbytes = 4 * B * H + ITEMSIZE[dtype] * V * H + 4 * V + 8 * B
    return Work(2 * B * H * V, nbytes)


def _gates(cfg: dict) -> int:
    return 4 if cfg["rnn_type"] == "lstm" else 3


def s2vt_forward_flops(cfg: dict, B: int) -> float:
    """Matrix-product operations of one teacher-forced S2VT forward
    (S2VTModel.py:63-81) at batch B, as its equations define them: the
    feature projection over L steps, both chains' input and recurrent
    products over the 2L-1 steps (the padding steps included), and the
    out-projection over the L-1 decoding steps."""
    L, F, H, E, V = cfg["length"], cfg["feat_dim"], cfg["dim_hidden"], cfg["dim_embed"], \
        cfg["vocab_size"]
    T, G = 2 * L - 1, _gates(cfg) * H
    return 2 * B * (L * F * H + T * (H * G + H * G) + T * ((E + H) * G + H * G)
                    + (L - 1) * H * V)


def s2vt_train_step_flops(cfg: dict, B: int) -> float:
    """Forward and backward of one train step: every product again for the
    gradient of its weight and of its input, except the input gradient of
    the feature projection, whose input is data."""
    L, F, H = cfg["length"], cfg["feat_dim"], cfg["dim_hidden"]
    fwd = s2vt_forward_flops(cfg, B)
    return 3 * fwd - 2 * B * L * F * H


def s2vt_greedy_flops(cfg: dict, B: int) -> float:
    """One greedy request (S2VTModel.py:82-110) at batch B: the feature
    projection, vid_rnn over 2L-1 steps, word_rnn over the L encoding steps,
    then L-1 decoding steps of word_rnn and the out-projection."""
    L, F, H, E, V = cfg["length"], cfg["feat_dim"], cfg["dim_hidden"], cfg["dim_embed"], \
        cfg["vocab_size"]
    T, G = 2 * L - 1, _gates(cfg) * H
    word_step = (E + H) * G + H * G
    return 2 * B * (L * F * H + T * 2 * H * G + L * word_step
                    + (L - 1) * (word_step + H * V))
