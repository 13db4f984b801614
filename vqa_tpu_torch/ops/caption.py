"""Caption attention and embedding of the Q-Relevant head (``q-cap``),
counterparts of ``vqa_tpu/ops/caption.py``.

The reference's ``CaptionEmbedding.forward_all`` cannot run (it reads
undefined ``word_hidden`` / ``cap_hidden``, SURVEY.md section 2.1 defect 2).
Both packages implement the intended algorithm, from the module docstrings
and the commented per-step implementation of the reference:

1. word RNN over the embedded caption tokens          -> h_word [B, T, H]
2. gate = sigmoid(drop(h_word * f(v)) + drop(h_word * f(q)))   [B, T, H]
3. caption RNN over gate * h_word                     -> h_cap  [B, T, H]
4. an LReLU layer                                     -> out    [B, T, H]
5. the element-wise max over the valid steps          -> [B, H]

Padded steps count as 0 in the max, not as -inf (the commented reference
fills its output buffer with zeros and writes only the valid steps), so a
row whose valid activations are all negative pools to 0. Both RNNs run the
plain scan (:meth:`SentenceEmbedding.forward_all`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.linear import LReLUNet
from vqa_tpu_torch.ops.rnn import SentenceEmbedding


class CaptionAttention(nn.Module):
    """gate = sigmoid(drop(h * f(v)) + drop(h * f(q))) (reference
    modules.py:202-243); ``f`` is an LReLU layer, ``W_v`` or ``W_q``."""

    def __init__(self, v_dim: int, q_dim: int, hidden_dim: int,
                 neg_slope: float = 0.01, dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.W_v = LReLUNet(v_dim, hidden_dim, neg_slope, generator=generator)
        self.W_q = LReLUNet(q_dim, hidden_dim, neg_slope, generator=generator)
        self.drop = nn.Dropout(dropout)

    def forward(self, h: torch.Tensor, v: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
        """h [B, T, H], v [B, v_dim], q [B, q_dim] -> [B, T, H] in (0, 1)."""
        jv = self.drop(h * self.W_v(v)[:, None, :])
        jq = self.drop(h * self.W_q(q)[:, None, :])
        return torch.sigmoid(jv + jq)


class CaptionEmbedding(nn.Module):
    """The question- and image-gated caption embedding with its max-pool
    (reference modules.py:246-306)."""

    def __init__(self, embed_dim: int, v_dim: int, q_dim: int,
                 hidden_dim: int, dropout: float = 0.2,
                 neg_slope: float = 0.01, rnn_type: str = "GRU", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.word_rnn = SentenceEmbedding(embed_dim, hidden_dim,
                                          rnn_type=rnn_type,
                                          generator=generator)
        self.attention = CaptionAttention(v_dim, q_dim, hidden_dim, neg_slope,
                                          dropout, generator=generator)
        self.caption_rnn = SentenceEmbedding(hidden_dim, hidden_dim,
                                             rnn_type=rnn_type,
                                             generator=generator)
        self.fcnet = LReLUNet(hidden_dim, hidden_dim, neg_slope,
                              generator=generator)

    def forward(self, v: torch.Tensor, q: torch.Tensor, c: torch.Tensor,
                cap_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """v [B, v_dim], q [B, q_dim], c [B, T, embed] (the embedded
        caption), ``cap_len`` [B] the valid lengths or None (a plain max
        over all T steps) -> [B, hidden]."""
        h_word = self.word_rnn.forward_all(c)
        gate = self.attention(h_word, v, q)
        out = self.fcnet(self.caption_rnn.forward_all(gate * h_word))
        if cap_len is not None:
            step = torch.arange(c.shape[1], device=c.device)[None, :, None]
            out = torch.where(step < cap_len[:, None, None], out, 0.0)
        return torch.amax(out, dim=1)
