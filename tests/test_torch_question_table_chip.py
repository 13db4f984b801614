"""The question GRU's vocabulary-table route on the card, at the staged
answering batches (B=8192 and 32768) and Up-Down's widths (20,001 rows of
300, H=1024, 10 steps): the input gates gathered from the projected table
equal the per-token gates within one bf16 ulp, the last state lies close to
the per-token route's, and gru_v2 still launches once a forward.

Marked ``chip``; each test skips without a CUDA card. This file imports no
JAX, so on a machine with the card and no JAX it runs without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -m chip tests/test_torch_question_table_chip.py -q
"""

from __future__ import annotations

import pytest
import torch

from vqa_tpu_torch.ops import rnn
from vqa_tpu_torch.ops.embedding import WordEmbedding
from vqa_tpu_torch.ops.kernels import _build, gru_v2

pytestmark = pytest.mark.chip

BF16 = torch.bfloat16
NTOKEN, EMBED, HIDDEN, Q_LEN = 20000, 300, 1024, 10
# the last state in bf16 (|h| < 1): a one-ulp change of a few gates moves
# it by a few bf16 ulps at most
STATE_TOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def xi_seen(monkeypatch):
    """gru_v2 as it is, keeping each call's input gates xi."""
    seen = []
    kernel = gru_v2.gru_last_state_v2

    def spy(xi, wh, bh):
        seen.append(xi)
        return kernel(xi, wh, bh)

    monkeypatch.setattr(gru_v2, "gru_last_state_v2", spy)
    return seen


@pytest.mark.parametrize("batch", [8192, 32768])
def test_table_route_matches_the_gates_route(cuda, xi_seen, batch):
    gen = torch.Generator().manual_seed(batch)
    emb = WordEmbedding(NTOKEN, EMBED, generator=gen).to(cuda, BF16).eval()
    q_rnn = rnn.SentenceEmbedding(EMBED, HIDDEN, use_pallas=True,
                                  generator=gen).to(cuda, BF16).eval()
    g = torch.Generator(device=cuda).manual_seed(batch)
    # question words uniform over the vocabulary, padded after 4-10 words
    words = torch.randint(0, NTOKEN, (batch, Q_LEN), generator=g, device=cuda)
    n = torch.randint(4, Q_LEN + 1, (batch, 1), generator=g, device=cuda)
    pos = torch.arange(Q_LEN, device=cuda)[None, :]
    tokens = torch.where(pos < n, words, torch.full_like(words, NTOKEN))

    rnn.reset_routes()
    launches = _build.LAUNCHES["gru_v2"]
    with torch.inference_mode():
        got = q_rnn.forward_tokens(tokens, emb)
        torch.cuda.synchronize()
        assert rnn.ROUTES == {"table": 1, "gates": 0}
        assert _build.LAUNCHES["gru_v2"] == launches + 1
        want = q_rnn(emb(tokens))
        torch.cuda.synchronize()
    assert rnn.ROUTES == {"table": 1, "gates": 1}
    assert _build.LAUNCHES["gru_v2"] == launches + 2

    xi_table, xi_gates = (x.float() for x in xi_seen)
    ulp = torch.maximum(xi_table.abs(), xi_gates.abs()) * 2.0 ** -7
    assert bool(((xi_table - xi_gates).abs() <= ulp).all())
    assert got.shape == (batch, HIDDEN) and got.dtype == BF16
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= STATE_TOL, err
