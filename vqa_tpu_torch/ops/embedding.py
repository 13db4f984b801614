"""Word embedding (counterpart of ``vqa_tpu/ops/embedding.py``).

- ``WordEmbedding``: a learned token table, or a frozen one
  (``frozen_table``: a GloVe table from :func:`load_glove_table`).
- ``load_glove_table``: a GloVe text file as a [lines + 4, dim] table, the
  four special rows ``<oov> <start> <end> <pad>`` zero at the end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class WordEmbedding(nn.Module):
    """Learned token table ``weight`` [ntoken + 1, embed_dim], N(0, 1) init
    with row ``ntoken`` (the padding_idx row of the reference's
    ``nn.Embedding(ntoken + 1, embed_dim, padding_idx=ntoken)``) zero.

    With ``frozen_table`` [rows, dim] the module holds that table instead,
    as a non-persistent buffer ``table``: no parameter, no optimizer state,
    no entry in ``state_dict`` or in a checkpoint, as in the JAX package
    (a constant there). It moves with the module (``.to``) and lives on the
    device the model runs on.
    """

    def __init__(self, ntoken: int, embed_dim: int, *,
                 frozen_table: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if frozen_table is not None:
            self.register_buffer(
                "table", torch.as_tensor(np.asarray(frozen_table,
                                                    dtype=np.float32)),
                persistent=False)
            self.weight = None
            return
        table = torch.randn(ntoken + 1, embed_dim, generator=generator)
        table[ntoken] = 0.0
        self.weight = nn.Parameter(table)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: int [...] -> [..., embed_dim]."""
        return F.embedding(tokens, self.table if self.weight is None
                           else self.weight)


def load_glove_table(vocab_path: str) -> np.ndarray:
    """Parse GloVe-format text (one ``word v_1 ... v_dim`` line a word) into
    a [len(lines) + 4, dim] float32 table: rows in file order, then four
    zero rows for ``<oov> <start> <end> <pad>`` (reference
    modules.py:166-199; ``vqa_tpu/ops/embedding.py`` ``load_glove_table``).
    The values are parsed in one ``np.loadtxt`` pass rather than line by
    line, with the same result."""
    with open(vocab_path) as f:
        dim = len(f.readline().split()) - 1
    vecs = np.loadtxt(vocab_path, dtype=np.float32, comments=None,
                      usecols=range(1, dim + 1), ndmin=2)
    table = np.zeros((len(vecs) + 4, dim), dtype=np.float32)
    table[:len(vecs)] = vecs
    return table
