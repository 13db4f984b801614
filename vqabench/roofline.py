"""The yardstick: the card's peaks, the least time of each kernel of the
port from its call's shapes, and the model FLOPs of the configurations.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 67 TFLOP/s f32 outside the tensor cores, 3.35
TB/s of HBM3. A kernel's least time is the largest of its bytes (each
input read once, each output written once) over the HBM rate, its
products over the peak of their type, and, for the decode-attention
kernels, the issue of their Philox draws: at least 40 instructions a
Philox4x32-10 call (10 rounds of two 32 x 32 -> 64-bit multiplies and two
three-input XORs), at one instruction a lane a clock, half the f32 rate.
These are the counts of ``chip_smoke.py`` (its ``bound``, ``gru_ops``
and the byte sums of its phases 6 and 9), frozen here.

Model FLOPs count the products of the model's equations (2 m k n for an
[m, k] x [k, n] product) as the plain reference computes them, forward
and, for training, backward: a gradient for each operand that needs one
(the box features are data), no recomputation.
Elementwise work (gates, softmax, dropout, the loss) is not counted.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PHILOX_INSTRUCTIONS = 40
ISSUE_PER_S = PEAK_OPS_PER_S["f32"] / 2
BF16, INT8 = 2, 1


def bound(nbytes: float, ops: float, kind: str, draws: float = 0.0):
    """(least seconds, "bytes" or "operations")."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": ops / PEAK_OPS_PER_S[kind],
             "philox": draws * PHILOX_INSTRUCTIONS / ISSUE_PER_S}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations"


def gru_v2(B: int, T: int, H: int):
    """The question GRU's recurrence over precomputed input gates: reads
    xi [B, T, 3H], w_h [H, 3H], b_h [3H], writes h [B, H]; the recurrent
    product on all steps but the first, whose state is zero."""
    nbytes = BF16 * (B * T * 3 * H + H * 3 * H + 3 * H + B * H)
    return bound(nbytes, 2.0 * B * 3 * H * (T - 1) * H, "bf16")


def dequant_matmul(M: int, K: int, N: int):
    """(x_q * scale) @ w: reads x_q [M, K] int8, scale [M], w [K, N],
    writes [M, N]."""
    nbytes = INT8 * M * K + BF16 * (M + K * N + M * N)
    return bound(nbytes, 2.0 * M * K * N, "bf16")


def pool_int8(B: int, N: int, D: int):
    """sum_n w[b, n] x_q[b, n, :]: reads w [B, N] and x_q [B, N, D] int8,
    writes [B, D]."""
    nbytes = BF16 * (B * N + B * D) + INT8 * B * N * D
    return bound(nbytes, 2.0 * B * N * D, "f32")


def _draws(B: int, objs: int, H: int, T: int = 1) -> int:
    return B * objs * -(-H // 16) * T


def decode_att_fwd(B: int, objs: int, H: int, D: int):
    """One scan step's attention and pooling over the int8 payload: reads
    vp [B, objs H], pool [B, objs D] int8, w [B, objs], qp [B, H], k [H],
    writes att [B, objs], att_v [B, D]."""
    nbytes = (BF16 * (B * objs * H + B * objs + B * H + H + B * objs + B * D)
              + INT8 * B * objs * D)
    return bound(nbytes, 2.0 * B * objs * (H + D), "f32", _draws(B, objs, H))


def decode_att_bwd(B: int, objs: int, H: int, D: int):
    """The reverse step: reads vp, pool (int8), w, att, g_attv [B, D],
    writes d_qp [B, H], m and dl [B, objs]."""
    nbytes = (BF16 * (B * objs * H + 2 * B * objs + B * D
                      + B * H + 2 * B * objs) + INT8 * B * objs * D)
    return bound(nbytes, 2.0 * B * objs * (H + D), "f32", _draws(B, objs, H))


def decode_att_dvp(T: int, B: int, objs: int, H: int):
    """The deferred gradient of vp over T steps: reads dls [T, B, objs],
    qps [T, B, H], k [H], writes [B, objs H]."""
    nbytes = BF16 * (T * B * objs + T * B * H + H + B * objs * H)
    return bound(nbytes, 2.0 * T * B * objs * H, "f32",
                 _draws(B, objs, H, T))


# ------------------------------------------------------------ model FLOPs


def _products(cfg: dict, caption_steps: int):
    """The model's products a sample: (count, k, n, grad of the input,
    grad of the weight)."""
    T, E, H = cfg["q_len"], cfg["embed_dim"], cfg["hidden_dim"]
    N, D, A = cfg["num_objs"], cfg["v_dim"], cfg["ans_dim"]
    out = [
        (T, E, 3 * H, True, True),      # question GRU, input
        (T - 1, H, 3 * H, True, True),  # question GRU, recurrent
        (1, H, 3 * H, False, True),     # (its zero first state: no gradient)
        (N, D, H, False, True),         # attention W_v on the features
        (1, H, H, True, True),          # attention W_q
        (N, H, 1, True, True),          # attention logits
        (1, N, D, True, False),         # pooling over the boxes (features: data)
        (1, H, H, True, True),          # q_net
        (1, D, H, True, True),          # v_net
        (1, H, 2 * H, True, True),      # classifier
        (1, 2 * H, A, True, True),
    ]
    if caption_steps:
        Hd, V, S = cfg["decoder_hidden_dim"], cfg["ntoken"], caption_steps
        out += [
            (N, D, Hd, True, True),          # decoder attention W_v
            (1, D, 3 * Hd, True, True),      # word GRU, the mean feature (once)
            (S, Hd + E, 3 * Hd, True, True),  # word GRU, [h2; word] inputs
            (S - 1, Hd, 3 * Hd, True, True),  # word GRU, recurrent
            (1, Hd, 3 * Hd, False, True),
            (S, Hd, Hd, True, True),         # query Linear
            (S, Hd, Hd, True, True),         # attention W_q
            (S * N, Hd, 1, True, True),      # attention logits
            (S, N, D, True, True),           # pooling (attended features)
            (S, D + Hd, 3 * Hd, True, True),  # language GRU, input
            (S - 1, Hd, 3 * Hd, True, True),  # language GRU, recurrent
            (1, Hd, 3 * Hd, False, True),
            (S, Hd, V, True, True),          # vocabulary
        ]
    return out


def answer_flops(cfg: dict) -> float:
    """Forward FLOPs of one answered question."""
    return sum(2.0 * c * k * n for c, k, n, _, _ in _products(cfg, 0))


def train_flops(cfg: dict, caption_steps: int = 0) -> float:
    """Forward and backward FLOPs of one training sample over
    ``caption_steps`` decoder steps (0 without a decoder)."""
    total = 0.0
    for c, k, n, dx, dw in _products(cfg, caption_steps):
        total += 2.0 * c * k * n * (1 + dx + dw)
    return total


def share(readings, pattern: str, least_s: float):
    """A kernel's share of its roofline in the traced window, in %: its
    launches times the least time of one, over their summed device time;
    None where the window launched it no time."""
    if readings.trace is None:
        return None
    seconds, launches = readings.trace.kernels(pattern)
    if not launches or seconds <= 0:
        return None
    return 100.0 * least_s * launches / seconds


def mfu(readings, flops_per_item: float, kind: str = "bf16"):
    """The window's model FLOPs a second over the card's peak, in %: the
    items (questions, samples) done in the traced window over its length
    on the host clock. The profiler's own host work is in that time, so
    where the host bounds the step this reads below the untraced rate's
    share."""
    t = readings.trace
    if t is None or t.window_s <= 0 or not t.launches():
        return None
    rate = readings.measurement["work"] / readings.trace.window_s
    return 100.0 * flops_per_item * rate / PEAK_OPS_PER_S[kind]
