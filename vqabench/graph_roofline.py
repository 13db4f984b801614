"""The yardstick of ReGAT's graph stage, beside ``vqabench/roofline.py``
(whose peaks and ``bound`` it uses): the least time of ``gcn_chain_fused``
from its call's shapes, as ``chip_smoke.py`` counts it (phase 11), and the
model FLOPs of one ReGAT answer.

The graph stage's products are counted in their folded form, the least
arithmetic that its equations allow and the form the program computes:
``w0 + w1`` as one weight (``adj @ f w0 + adj @ f w1 = adj @ f (w0 +
w1)``) and the correlation's two projections as one matrix ``C = Wa
Wb^T`` (``(f Wa)(f Wb)^T = (f C) f^T``). The plain reference's unfolded
form does two more [36, 2048] x [2048, 2048] products a question: counted
so, the share of the peak would credit the card with work it never does,
and could pass 100% where the program does the least arithmetic. The
correlation's bias terms (two [36, 2048] x [2048] products) and
elementwise work are not counted.
"""

from __future__ import annotations

from vqabench import roofline


def gcn_chain(B: int, N: int, D: int, labels: int):
    """gcn_chain_fused: reads out_self and proj [B, N, D], alpha_raw [B, N,
    N], the int32 graph [B, N, N] and bias [labels, D], writes [B, N, D]
    (bf16 but the graph); the products adj @ alpha_raw, adj @ proj, counts
    @ bias and the softmaxed alpha @ o."""
    nbytes = (roofline.BF16 * (3 * B * N * D + B * N * N + labels * D)
              + 4 * B * N * N)
    ops = 2.0 * B * N * (N * (2 * D + N) + labels * D)
    return roofline.bound(nbytes, ops, "bf16")


def _graph_products(cfg: dict):
    """The graph stage's products a question: (count, m, k, n)."""
    N, D, L = cfg["num_objs"], cfg["v_dim"], cfg["num_labels"]
    return [
        (3, N, D, D),      # w_self, w0 + w1, f C
        (1, N, D, N),      # the correlation (f C) f^T
        (1, N, N, N),      # adj @ ReLU(alpha)
        (2, N, N, D),      # adj @ proj, alpha @ o
        (1, N, L, D),      # label counts @ label_bias
    ]


def graph_flops(cfg: dict) -> float:
    """Forward FLOPs of the graph stage for one question, per
    ``conv_layer``."""
    per_layer = sum(2.0 * c * m * k * n for c, m, k, n in _graph_products(cfg))
    return cfg["conv_layer"] * per_layer


def answer_flops(cfg: dict) -> float:
    """Forward FLOPs of one ReGAT answer: Up-Down's (``roofline``) and the
    graph stage's."""
    return roofline.answer_flops(cfg) + graph_flops(cfg)
