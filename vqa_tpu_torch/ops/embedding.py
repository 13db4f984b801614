"""Word embedding (counterpart of ``vqa_tpu/ops/embedding.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class WordEmbedding(nn.Module):
    """Learned token table ``weight`` [ntoken + 1, embed_dim], N(0, 1) init
    with row ``ntoken`` (the padding_idx row of the reference's
    ``nn.Embedding(ntoken + 1, embed_dim, padding_idx=ntoken)``) zero."""

    def __init__(self, ntoken: int, embed_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = torch.randn(ntoken + 1, embed_dim, generator=generator)
        table[ntoken] = 0.0
        self.weight = nn.Parameter(table)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: int [...] -> [..., embed_dim]."""
        return F.embedding(tokens, self.weight)
