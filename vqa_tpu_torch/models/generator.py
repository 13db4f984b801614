"""Caption decoders (counterpart of ``vqa_tpu/models/generator.py``).

- ``BaseDecoder``: Show-Attend-Tell, one GRU/LSTM cell; each step attends
  over the boxes with the current state and feeds ``[prev_word; att_v]``
  to the cell.
- ``BUTDDecoder``: the Up-Down two-cell decoder, word RNN -> attention ->
  language RNN.

Both run one step at a time through ``decode`` (the beam search's step, and
the teacher-forced forward's), with the attention's v-projection computed
once per batch by ``project_v`` and passed to every step as ``att_cache``.
The teacher-forced forward runs all ``max_len - 1`` steps for the whole
batch and masks the positions past each caption's length.

Init quirks kept from the reference: BaseDecoder's vocab head is
U(-0.1, 0.1) with a zero bias; BUTDDecoder's heads keep torch's default
Linear init. Parameters carry the reference's torch names (``word_rnn``
``weight_ih`` ..., ``h2_fcnet.weight`` [out, in]).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.attention import set_att
from vqa_tpu_torch.ops.linear import uniform_
from vqa_tpu_torch.ops.rnn import RNNCell


class Dense(nn.Module):
    """A plain Linear, ``weight`` [out, in] and ``bias`` [out] (the JAX
    package's ``_Dense``): the product in the input's dtype, then the bias
    in that dtype. Init U(-1/sqrt(in), 1/sqrt(in)) unless ``bound`` is
    given; ``zero_bias`` starts the bias at 0."""

    def __init__(self, in_dim: int, out_dim: int,
                 bound: Optional[float] = None, zero_bias: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        default = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(uniform_(torch.empty(out_dim, in_dim),
                                            bound or default, generator))
        self.bias = nn.Parameter(
            torch.zeros(out_dim) if zero_bias
            else uniform_(torch.empty(out_dim), default, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.to(x.dtype).t()) \
            + self.bias.to(x.dtype)


def _out(state):
    """The output h of a cell's carry (an LSTM carries (h, c))."""
    return state[0] if isinstance(state, tuple) else state


class DecoderBase(nn.Module):
    """The teacher-forced loop and the helpers both decoders share."""

    h_num = 1

    def __init__(self, ntoken: int, v_dim: int, hidden_dim: int,
                 max_len: int, dropout: float, rnn_type: str, att_type: str,
                 att_dropout: float, generator: Optional[torch.Generator]):
        super().__init__()
        self.ntoken = ntoken
        self.hidden_dim = hidden_dim
        self.max_len = max_len
        self.rnn_type = rnn_type
        att_kwargs = {"dropout": att_dropout} if att_type == "new" else {}
        self.attention = set_att(att_type)(v_dim, hidden_dim, hidden_dim,
                                           generator=generator, **att_kwargs)
        self.drop = nn.Dropout(dropout)

    def vocab_head(self) -> Dense:
        raise NotImplementedError

    def init_hidden(self, batch_size: int, dtype: torch.dtype,
                    device: Optional[torch.device] = None) -> List:
        """Zero states, one per cell; an LSTM's is an (h, c) pair."""
        init = torch.zeros((batch_size, self.hidden_dim), dtype=dtype,
                           device=device)
        return [(init, init) if self.rnn_type == "LSTM" else init
                for _ in range(self.h_num)]

    def project_v(self, v: torch.Tensor) -> torch.Tensor:
        """The attention's v-projection, which no step changes: compute it
        once per batch and pass it to every ``decode`` as ``att_cache``."""
        return self.attention.project_v(v)

    def _attend(self, v: torch.Tensor, q: torch.Tensor,
                att_cache: Optional[torch.Tensor], beam: int):
        """(att, attended features) of q against the boxes. ``beam > 1``: q
        [B * beam, H] against per-image v [B, objs, v_dim], which each
        image's beams read once."""
        if beam > 1:
            batch = v.shape[0]
            att = self.attention(v, q.reshape(batch, beam, -1),
                                 v_cache=att_cache)       # [B, beam, n, 1]
            dt = torch.promote_types(att.dtype, v.dtype)
            att_v = torch.einsum("bkn,bnd->bkd", att[..., 0].to(dt), v.to(dt))
            return att.reshape(batch * beam, -1, 1), \
                att_v.reshape(batch * beam, -1)
        att = self.attention(v, q, v_cache=att_cache)
        return att, torch.sum(att * v, dim=1)

    def decode(self, v, v_mean, prev, h, *, att_cache=None, beam: int = 1,
               return_features: bool = False):
        raise NotImplementedError

    def forward(self, embed: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward over all steps with a validity mask.

        ``embed`` needs ``v`` [B, objs, v_dim], ``c`` [B, c_len, embed] (the
        embedded caption), ``cap_len`` [B] and ``c_target`` [B, c_len].
        Returns ``predict`` [B, max_len - 1, ntoken], ``target`` [B,
        max_len - 1] (the words after <start>) and ``mask`` [B,
        max_len - 1]: step t is valid iff t < cap_len - 1.
        """
        v, caption = embed["v"], embed["c"]
        steps = self.max_len - 1     # no step decodes at the <end> position
        v_mean = torch.mean(v, dim=1)
        h = self.init_hidden(v.shape[0], v.dtype, v.device)
        att_cache = self.project_v(v)
        outputs = []
        for t in range(steps):
            h, word, _ = self.decode(v, v_mean, caption[:, t], h,
                                     att_cache=att_cache)
            outputs.append(word)
        predict = torch.stack(outputs, dim=1)
        mask = (torch.arange(steps, device=v.device)[None, :]
                < (embed["cap_len"][:, None] - 1))
        return {"predict": predict,
                "target": embed["c_target"][:, 1:self.max_len],
                "mask": mask.to(predict.dtype)}


class BaseDecoder(DecoderBase):
    """Show-Attend-Tell single-cell decoder (generator.py:375-425)."""

    h_num = 1

    def __init__(self, ntoken: int, v_dim: int, embed_dim: int,
                 hidden_dim: int, max_len: int, dropout: float = 0.5,
                 rnn_type: str = "GRU", att_type: str = "base",
                 att_dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(ntoken, v_dim, hidden_dim, max_len, dropout,
                         rnn_type, att_type, att_dropout, generator)
        self.rnn = RNNCell(embed_dim + v_dim, hidden_dim, rnn_type,
                           generator=generator)
        self.fcnet = Dense(hidden_dim, ntoken, bound=0.1, zero_bias=True,
                           generator=generator)

    def vocab_head(self) -> Dense:
        return self.fcnet

    def decode(self, v, v_mean, prev, h, *, att_cache=None, beam: int = 1,
               return_features: bool = False):
        """One step: attend with h, feed [prev; att_v] to the cell. Returns
        (h, logits [B, ntoken] or, with ``return_features``, the vocab head's
        input [B, H], att). ``beam``: see :meth:`DecoderBase._attend`."""
        del v_mean   # the single-cell decoder has no v_mean input
        att, att_v = self._attend(v, _out(h[0]), att_cache, beam)
        state = self.rnn(h[0], torch.cat([prev, att_v], dim=1))
        feat = self.drop(_out(state))
        return [state], feat if return_features else self.fcnet(feat), att


class BUTDDecoder(DecoderBase):
    """Up-Down two-cell decoder (generator.py:428-498)."""

    h_num = 2

    def __init__(self, ntoken: int, v_dim: int, embed_dim: int,
                 hidden_dim: int, max_len: int, dropout: float = 0.5,
                 rnn_type: str = "GRU", att_type: str = "base",
                 att_dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(ntoken, v_dim, hidden_dim, max_len, dropout,
                         rnn_type, att_type, att_dropout, generator)
        self.word_rnn = RNNCell(hidden_dim + v_dim + embed_dim, hidden_dim,
                                rnn_type, generator=generator)
        self.language_rnn = RNNCell(v_dim + hidden_dim, hidden_dim, rnn_type,
                                    generator=generator)
        self.h1_fcnet = Dense(hidden_dim, hidden_dim, generator=generator)
        self.h2_fcnet = Dense(hidden_dim, ntoken, generator=generator)

    def vocab_head(self) -> Dense:
        return self.h2_fcnet

    def decode(self, v, v_mean, prev, h, *, att_cache=None, beam: int = 1,
               return_features: bool = False):
        """word RNN -> h1 FC -> attention -> language RNN -> vocab logits.
        ``beam``/``return_features``: see :meth:`BaseDecoder.decode`."""
        h1, h2 = h
        h1 = self.word_rnn(h1, torch.cat([_out(h2), v_mean, prev], dim=1))
        hq = self.h1_fcnet(self.drop(_out(h1)))
        att, att_v = self._attend(v, hq, att_cache, beam)
        h2 = self.language_rnn(h2, torch.cat([att_v, hq], dim=1))
        feat = self.drop(_out(h2))
        return [h1, h2], feat if return_features else self.h2_fcnet(feat), att


def set_decoder(decoder_type: str, ntoken: int, hidden_dim: int,
                max_len: int, dropout: float = 0.5, rnn_type: str = "GRU",
                att_type: str = "base", att_dropout: float = 0.2, *,
                v_dim: int, embed_dim: int,
                generator: Optional[torch.Generator] = None
                ) -> Optional[DecoderBase]:
    """String-keyed decoder factory (generator.py:501-516). The port's cells
    declare their input widths, so it also takes ``v_dim`` and
    ``embed_dim``."""
    if decoder_type == "none":
        return None
    cls = {"base": BaseDecoder, "butd": BUTDDecoder}[decoder_type]
    return cls(ntoken, v_dim, embed_dim, hidden_dim, max_len,
               dropout=dropout, rnn_type=rnn_type, att_type=att_type,
               att_dropout=att_dropout, generator=generator)
