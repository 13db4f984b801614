"""Model FLOPs of Q-Relevant's max-relevance step (``vqabench/reference/
qrel.py``), a question: what the mathematics needs, not what a given form
of the step repeats, so that a faster form of the same step is held to the
same count.

Products (2 m k n for an [m, k] x [k, n] product), by what they depend on:

- ``encoder``, once a question: the question GRU (input and recurrence),
  the attention's v and q projections and logits, ``q_net``;
- ``box``, once a question: the head's box projection ``v_net`` over the
  attended features, which no caption changes;
- ``question_head``, once a question: the head's layers of the question
  and the summed boxes alone (the caption gates' two projections,
  ``vq_net``);
- ``candidate``, once a candidate caption: the word GRU, the caption GRU,
  the LReLU layer over its steps, ``c_net``, ``joint_net``, ``vqc_net``
  and the classifier;
- ``decoder``, once a question (the chosen caption): the BUTD decoder's
  products over ``c_len - 1`` steps, the mean feature's input gates once.

A GRU's recurrent product on its zero first state is not counted.
Elementwise work (gates, softmaxes, dropout, the gathers, the losses) is
not counted. The forward counts every candidate; the backward flows
through the chosen candidate alone and is counted as twice the forward's
products over the encoder, the box projection, the question's head, one
candidate and the decoder.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Product = Tuple[int, int, int]          # (count, k, n) a question


def products(cfg: dict) -> Dict[str, List[Product]]:
    """The step's products a question, by the groups of the module
    docstring."""
    T, E, H = cfg["q_len"], cfg["embed_dim"], cfg["hidden_dim"]
    N, D, A = cfg["num_objs"], cfg["v_dim"], cfg["ans_dim"]
    C, Hd, V = cfg["c_len"], cfg["decoder_hidden_dim"], cfg["ntoken"]
    S = C - 1
    return {
        "encoder": [(T, E, 3 * H),          # question GRU, input
                    (T - 1, H, 3 * H),      # question GRU, recurrent
                    (N, D, H),              # attention W_v
                    (1, H, H),              # attention W_q
                    (N, H, 1),              # attention logits
                    (1, H, H)],             # q_net
        "box": [(N, D, H)],                 # v_net, box by box
        "question_head": [(1, H, H),        # caption gate W_v (summed boxes)
                          (1, H, H),        # caption gate W_q (question)
                          (1, H, H)],       # vq_net
        "candidate": [(C, E, 3 * H),        # word GRU, input
                      (C - 1, H, 3 * H),    # word GRU, recurrent
                      (C, H, 3 * H),        # caption GRU, input
                      (C - 1, H, 3 * H),    # caption GRU, recurrent
                      (C, H, H),            # the LReLU layer over the steps
                      (1, H, H),            # c_net
                      (1, H, H),            # joint_net
                      (1, H, H),            # vqc_net
                      (1, H, A)],           # classifier
        "decoder": [(N, D, Hd),             # attention W_v
                    (1, D, 3 * Hd),         # word GRU, the mean feature
                    (S, Hd + E, 3 * Hd),    # word GRU, [h2; word]
                    (S - 1, Hd, 3 * Hd),    # word GRU, recurrent
                    (S, Hd, Hd),            # query Linear
                    (S, Hd, Hd),            # attention W_q
                    (S * N, Hd, 1),         # attention logits
                    (S, N, D),              # pooling (attended features)
                    (S, D + Hd, 3 * Hd),    # language GRU, input
                    (S - 1, Hd, 3 * Hd),    # language GRU, recurrent
                    (S, Hd, V)],            # vocabulary
    }


def group_flops(cfg: dict) -> Dict[str, float]:
    """Forward FLOPs a question (a candidate for ``candidate``) of each
    group."""
    return {g: sum(2.0 * c * k * n for c, k, n in ps)
            for g, ps in products(cfg).items()}


def forward_flops(cfg: dict) -> float:
    """Forward FLOPs a question: every candidate's head."""
    g = group_flops(cfg)
    return (g["encoder"] + g["box"] + g["question_head"]
            + cfg["n_cap"] * g["candidate"] + g["decoder"])


def train_flops(cfg: dict) -> float:
    """Forward and backward FLOPs a trained question."""
    g = group_flops(cfg)
    chosen = (g["encoder"] + g["box"] + g["question_head"] + g["candidate"]
              + g["decoder"])
    return forward_flops(cfg) + 2.0 * chosen
