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

Training goes through ``caption_loss``: the masked caption CE with the
vocab head run once on the stacked step features, in row chunks. The BUTD
decoder with GRU cells and MultiplyAttention (the MTL configuration) runs
its steps through the custom-backward scan of ``ops/decode_scan.py``, whose
attention goes to the decode-attention kernels with ``pallas_att``.

Init quirks kept from the reference: BaseDecoder's vocab head is
U(-0.1, 0.1) with a zero bias; BUTDDecoder's heads keep torch's default
Linear init. Parameters carry the reference's torch names (``word_rnn``
``weight_ih`` ..., ``h2_fcnet.weight`` [out, in]).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from vqa_tpu_torch.ops.attention import set_att
from vqa_tpu_torch.ops.decode_scan import SCAN_PARAMS, make_butd_caption_scan
from vqa_tpu_torch.ops.linear import Dense
from vqa_tpu_torch.ops.rnn import RNNCell


def token_mean(total: torch.Tensor, count: torch.Tensor,
               token_count=None) -> torch.Tensor:
    """``total / max(count, 1)``, the caption CE's mean over valid tokens.
    ``token_count`` maps the batch's count to the one to divide by (a
    data-parallel step's: the mean count of its data group)."""
    if token_count is not None:
        count = token_count(count)
    return total / torch.clamp(count, min=1.0)


def _out(state):
    """The output h of a cell's carry (an LSTM carries (h, c))."""
    return state[0] if isinstance(state, tuple) else state


class DecoderBase(nn.Module):
    """The teacher-forced loop and the helpers both decoders share."""

    h_num = 1
    # one chunk's logits stay under this many bytes in the caption CE: its
    # logits and their gradient coexist in the backward
    CE_CHUNK_BYTES = 1 << 30

    def __init__(self, ntoken: int, v_dim: int, hidden_dim: int,
                 max_len: int, dropout: float, rnn_type: str, att_type: str,
                 att_dropout: float, generator: Optional[torch.Generator],
                 pallas_att: bool = False):
        super().__init__()
        self.ntoken = ntoken
        self.hidden_dim = hidden_dim
        self.max_len = max_len
        self.rnn_type = rnn_type
        self.att_type = att_type
        self.dropout = dropout
        self.att_dropout = att_dropout
        self.pallas_att = pallas_att
        att_kwargs = {"dropout": att_dropout} if att_type == "new" else {}
        self.attention = set_att(att_type)(v_dim, hidden_dim, hidden_dim,
                                           generator=generator, **att_kwargs)
        self.drop = nn.Dropout(dropout)

    def vocab_head(self) -> Dense:
        raise NotImplementedError

    def hoisted_gates(self, v_mean: torch.Tensor, prev_dim: int):
        """The input gates of the step-invariant input rows (BUTD's
        ``v_mean``); None where a decoder has none."""
        return None

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
               return_features: bool = False, v_gate_cache=None):
        raise NotImplementedError

    def caption_loss(self, embed: Dict[str, torch.Tensor], *,
                     seed: Optional[int] = None,
                     token_count=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced masked caption CE (``forward`` +
        ``wrapper.ce_for_language_model`` in one), dropout active in
        training mode.

        The steps emit their pre-logit features; the vocab head and the CE
        run once on the stacked [B, steps, H] after them
        (``_vocab_ce_sum``). The attention's v-projection and the word RNN's
        v_mean gates are computed once. The time axis follows ``embed['c']``,
        so a length-bucketed batch runs fewer steps for the same loss.
        ``seed``: the scan's 32-bit dropout seed (drawn from torch's CPU
        generator when None); ``token_count``: see :func:`token_mean`.
        Returns {'loss', 'mask_sum'} (the batch's own count).
        """
        v, caption = embed["v"], embed["c"]
        steps = caption.shape[1] - 1
        v_mean = torch.mean(v, dim=1)
        h = self.init_hidden(v.shape[0], v.dtype, v.device)
        att_cache = self.project_v(v)
        v_gates = self.hoisted_gates(v_mean, caption.shape[-1])
        acc_dtype = torch.promote_types(v.dtype, torch.float32)
        mask = (torch.arange(steps, device=v.device)[None, :]
                < (embed["cap_len"][:, None] - 1)).to(acc_dtype)
        prev_seq = caption[:, :steps]
        if self._fused_scan_ok(v_gates):
            if seed is None:
                seed = int(torch.randint(0, 1 << 32, (), dtype=torch.int64))
            factored = "v_q8" in embed
            scan_fn, _ = make_butd_caption_scan(
                hidden_dim=self.hidden_dim, v_dim=v.shape[-1],
                dropout=self.dropout, att_dropout=self.att_dropout,
                deterministic=not self.training, factored_v=factored,
                pallas_att=self.pallas_att)
            P = {n: _attr(self, n) for n in SCAN_PARAMS}
            vis = ((embed["v_q8"], embed["v_w"].to(v.dtype)) if factored
                   else (v,))
            feats = scan_fn(P, *vis, att_cache, v_gates, prev_seq, h[0], h[1],
                            seed).transpose(0, 1)
        else:
            outs = []
            for t in range(steps):
                h, feat, _ = self.decode(v, v_mean, prev_seq[:, t], h,
                                         att_cache=att_cache,
                                         return_features=True,
                                         v_gate_cache=v_gates)
                outs.append(feat)
            feats = torch.stack(outs, dim=1)
        target = embed["c_target"][:, 1:steps + 1]
        nll_sum = self._vocab_ce_sum(feats, target, mask, acc_dtype)
        mask_sum = mask.sum()
        return {"loss": token_mean(nll_sum, mask_sum, token_count),
                "mask_sum": mask_sum}

    def _fused_scan_ok(self, v_gates) -> bool:
        """The custom-backward scan covers the MTL decoder: BUTD (two GRU
        cells, signalled by a hoisted gate cache) with MultiplyAttention."""
        return (self.h_num == 2 and self.rnn_type == "GRU"
                and self.att_type == "new" and v_gates is not None)

    def _ce_rows(self, feats: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
        """sum over rows of mask * (lse(head(feat)) - logit[target]), in
        ``acc_dtype`` (>= f32); the log-softmax array is never formed."""
        logits = self.vocab_head()(feats)                    # [rows, V]
        m = torch.amax(logits, dim=-1, keepdim=True).detach().to(acc_dtype)
        lse = m[..., 0] + torch.log(torch.sum(
            torch.exp(logits.to(acc_dtype) - m), dim=-1))
        tgt = torch.gather(logits, -1, target[..., None].long())[..., 0]
        return torch.sum((lse - tgt.to(acc_dtype)) * mask)

    def _vocab_ce_sum(self, feats: torch.Tensor, target: torch.Tensor,
                      mask: torch.Tensor, acc_dtype: torch.dtype
                      ) -> torch.Tensor:
        """Masked CE sum over [B, T] rows with the logits' memory bounded:
        where one pass's [B * T, V] logits would pass ``CE_CHUNK_BYTES``,
        the rows go in chunks, each checkpointed, so the backward
        recomputes one chunk's logits at a time."""
        rows = feats.shape[0] * feats.shape[1]
        feats = feats.reshape(rows, -1)
        target, mask = target.reshape(rows), mask.reshape(rows)
        n = max(1, -(-(rows * self.ntoken * feats.element_size())
                     // self.CE_CHUNK_BYTES))
        if n == 1:
            return self._ce_rows(feats, target, mask, acc_dtype)
        rc = -(-rows // n)
        total = torch.zeros((), dtype=acc_dtype, device=feats.device)
        for sl in range(0, rows, rc):
            total = total + checkpoint(
                self._ce_rows, feats[sl:sl + rc], target[sl:sl + rc],
                mask[sl:sl + rc], acc_dtype, use_reentrant=False)
        return total

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
                 generator: Optional[torch.Generator] = None,
                 pallas_att: bool = False):
        super().__init__(ntoken, v_dim, hidden_dim, max_len, dropout,
                         rnn_type, att_type, att_dropout, generator,
                         pallas_att)
        self.rnn = RNNCell(embed_dim + v_dim, hidden_dim, rnn_type,
                           generator=generator)
        self.fcnet = Dense(hidden_dim, ntoken, bound=0.1, zero_bias=True,
                           generator=generator)

    def vocab_head(self) -> Dense:
        return self.fcnet

    def decode(self, v, v_mean, prev, h, *, att_cache=None, beam: int = 1,
               return_features: bool = False, v_gate_cache=None):
        """One step: attend with h, feed [prev; att_v] to the cell. Returns
        (h, logits [B, ntoken] or, with ``return_features``, the vocab head's
        input [B, H], att). ``beam``: see :meth:`DecoderBase._attend`."""
        del v_mean   # the single-cell decoder has no v_mean input
        if v_gate_cache is not None:
            raise ValueError("BaseDecoder has no step-invariant cell input")
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
                 generator: Optional[torch.Generator] = None,
                 pallas_att: bool = False):
        super().__init__(ntoken, v_dim, hidden_dim, max_len, dropout,
                         rnn_type, att_type, att_dropout, generator,
                         pallas_att)
        self.word_rnn = RNNCell(hidden_dim + v_dim + embed_dim, hidden_dim,
                                rnn_type, generator=generator)
        self.language_rnn = RNNCell(v_dim + hidden_dim, hidden_dim, rnn_type,
                                    generator=generator)
        self.h1_fcnet = Dense(hidden_dim, hidden_dim, generator=generator)
        self.h2_fcnet = Dense(hidden_dim, ntoken, generator=generator)

    def vocab_head(self) -> Dense:
        return self.h2_fcnet

    def hoisted_gates(self, v_mean: torch.Tensor, prev_dim: int):
        """The word RNN's input gates of its v_mean rows, which no step
        changes: ``v_mean @ weight_ih[:, H:H + v_dim].T`` (no bias). The
        input GEMM splits exactly over the concatenation's row blocks."""
        hd, vd = self.hidden_dim, v_mean.shape[-1]
        return self.word_rnn(None, v_mean, rows=(hd, hd + vd),
                             gates_only=True)

    def decode(self, v, v_mean, prev, h, *, att_cache=None, beam: int = 1,
               return_features: bool = False, v_gate_cache=None):
        """word RNN -> h1 FC -> attention -> language RNN -> vocab logits.
        ``beam``/``return_features``: see :meth:`BaseDecoder.decode`;
        ``v_gate_cache``: the precomputed :meth:`hoisted_gates`."""
        h1, h2 = h
        if v_gate_cache is not None:
            hd, vd, pd = self.hidden_dim, v_mean.shape[-1], prev.shape[-1]
            h1 = self.word_rnn(h1, torch.cat([_out(h2), prev], dim=1),
                               rows=[(0, hd), (hd + vd, hd + vd + pd)],
                               extra_xi=v_gate_cache)
        else:
            h1 = self.word_rnn(h1, torch.cat([_out(h2), v_mean, prev], dim=1))
        hq = self.h1_fcnet(self.drop(_out(h1)))
        att, att_v = self._attend(v, hq, att_cache, beam)
        h2 = self.language_rnn(h2, torch.cat([att_v, hq], dim=1))
        feat = self.drop(_out(h2))
        return [h1, h2], feat if return_features else self.h2_fcnet(feat), att


def set_decoder(decoder_type: str, ntoken: int, hidden_dim: int,
                max_len: int, dropout: float = 0.5, rnn_type: str = "GRU",
                att_type: str = "base", att_dropout: float = 0.2,
                pallas_att: bool = False, *, v_dim: int, embed_dim: int,
                generator: Optional[torch.Generator] = None
                ) -> Optional[DecoderBase]:
    """String-keyed decoder factory (generator.py:501-516). The port's cells
    declare their input widths, so it also takes ``v_dim`` and
    ``embed_dim``. ``pallas_att`` sends the training scan's attention to
    the decode-attention kernels."""
    if decoder_type == "none":
        return None
    cls = {"base": BaseDecoder, "butd": BUTDDecoder}[decoder_type]
    return cls(ntoken, v_dim, embed_dim, hidden_dim, max_len,
               dropout=dropout, rnn_type=rnn_type, att_type=att_type,
               att_dropout=att_dropout, generator=generator,
               pallas_att=pallas_att)


def _attr(module: nn.Module, name: str) -> torch.Tensor:
    """The tensor at a dotted attribute path (also under
    ``torch.func.functional_call``, which swaps parameters for tensors)."""
    for part in name.split("."):
        module = getattr(module, part)
    return module
