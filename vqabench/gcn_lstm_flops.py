"""Model FLOPs of a GCN-LSTM training sample (``vqabench/reference/
gcn_lstm.py``): the products of ``vqabench/roofline.py`` for the encoder
(the question GRU and the top-down attention) and the BUTD decoder,
without the VQA head's (its pooling, ``q_net``, ``v_net`` and the
classifier), and the graph stage's products in the folded form of
``vqabench/graph_roofline.py`` (``w0 + w1`` as one weight, the
correlation as ``(f C) f^T``), which says why.

The backward counts a product once for each operand that takes a
gradient: the box features, the adjacency and the label counts are data;
the attended features, the graph stage's activations and every weight
take one. Elementwise work (gates, softmaxes, dropout, the loss) is not
counted, as in ``roofline``.
"""

from __future__ import annotations

from vqabench import roofline

# roofline._products' encoder entries: the question GRU's input and
# recurrent products and its zero first state, the attention's W_v, W_q
# and logits; the VQA head's follow them
ENCODER_PRODUCTS = 6


def graph_products(cfg: dict):
    """The graph stage's products a sample, per convolution: (count, m,
    k, n, gradient of the left operand, of the right)."""
    N, D, L = cfg["num_objs"], cfg["v_dim"], cfg["num_labels"]
    return [
        (3, N, D, D, True, True),     # w_self, w0 + w1, f C
        (1, N, D, N, True, True),     # the correlation (f C) f^T
        (1, N, N, N, False, True),    # adj @ ReLU(alpha)
        (1, N, N, D, False, True),    # adj @ proj
        (1, N, N, D, True, True),     # alpha @ out
        (1, N, L, D, False, True),    # label counts @ label_bias
    ]


def _sum(products, backward: bool) -> float:
    return sum(2.0 * c * m * k * n * (1 + (dx + dw if backward else 0))
               for c, m, k, n, dx, dw in products)


def products(cfg: dict):
    """Every product a sample as (count, m, k, n, dx, dw): the encoder's
    and the decoder's of ``roofline._products`` (one row each, m = 1),
    then the graph stage's, ``conv_layer`` times."""
    head_free = dict(cfg, ans_dim=0)       # the head's entries are dropped
    vqa = roofline._products(head_free, 0)
    caption = roofline._products(head_free, cfg["c_len"] - 1)[len(vqa):]
    rows = [(c, 1, k, n, dx, dw)
            for c, k, n, dx, dw in vqa[:ENCODER_PRODUCTS] + caption]
    return rows + graph_products(cfg) * cfg["conv_layer"]


def forward_flops(cfg: dict) -> float:
    """Forward FLOPs of one training sample."""
    return _sum(products(cfg), False)


def train_flops(cfg: dict) -> float:
    """Forward and backward FLOPs of one training sample."""
    return _sum(products(cfg), True)
