"""Batched beam-search caption decoding on the device (counterpart of
``vqa_tpu/tools/beam.py``).

Every step expands all ``batch x k`` beams with one decoder call, re-ranks
the candidates and gathers the hidden states by beam index, all on the
device: the loop over steps never synchronises with the host.

The candidate shrink, the finished-beam handling and the final ranking are
the JAX package's: per-beam top-k of the step's log-probabilities (the
global top-k over k*V candidates lies in the union of each beam's top-k,
and log_softmax is a per-row shift of the logits), candidates scored by
log-probability (or the raw logits with ``legacy_logit_scores``, the
reference's scoring), and beams ranked by length-normalised log-probability,
finished ones first. Ties go to the lowest index at every top-k, as
``lax.top_k`` and ``jnp.argsort`` give them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqa_tpu_torch.ops.kernels import vocab_topk

NEG_INF = -1e9


def _reorder(h: List, flat_idx: torch.Tensor) -> List:
    """Gather each cell's carry (an LSTM's is an (h, c) pair) by row."""
    return [tuple(x[flat_idx] for x in s) if isinstance(s, tuple)
            else s[flat_idx] for s in h]


def make_beam_search(model, k: int, c_len: int, start_id: int, end_id: int,
                     legacy_logit_scores: bool = False,
                     fused_vocab: bool = False
                     ) -> Callable[[Dict[str, torch.Tensor]],
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """Build ``batch -> (tokens, scores)``: tokens [B, k, c_len] int64
    (beams best first), scores [B, k] length-normalised log-probabilities.
    Call it with the model in eval mode.

    ``fused_vocab``: the vocab head of every step goes through
    :func:`vocab_topk.vocab_topk_lse` (GEMM + exact running top-k + online
    logsumexp, the [B*k, ntoken] logits never formed), which computes in
    f32 where the plain head rounds its logits to the activation dtype;
    where the kernel does not take the shape (``vocab_topk.supports``), its
    plain version computes the same f32 numbers. The head must be a plain
    ``{weight, bias}`` Linear.
    """
    generator = model.generator
    if generator is None:
        raise ValueError("model has no caption generator")
    head = generator.vocab_head()
    if fused_vocab:
        names = sorted(name for name, _ in head.named_parameters())
        if names != ["bias", "weight"]:
            raise ValueError(
                "fused_vocab requires a plain {weight, bias} Linear vocab "
                f"head; the generator's head has parameters {names}: run "
                "with fused_vocab=False")

    @torch.no_grad()
    def beam_search(batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        v = model.encoder(batch)["v"]                    # [B, objs, v_dim]
        batch_size, dev = v.shape[0], v.device
        # v stays per image (beam-mode attention reads each image's boxes
        # once for its k beams); only the mean, a cell input, is tiled
        v_mean = torch.mean(v, dim=1).repeat_interleave(k, dim=0)
        att_cache = generator.project_v(v)
        tokens = torch.full((batch_size, k, c_len), end_id, dtype=torch.long,
                            device=dev)
        tokens[:, :, 0] = start_id
        # only beam 0 is live at first (no k duplicate beams)
        first_only = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                                 NEG_INF)                          # [k] f32
        logp = first_only.expand(batch_size, k).clone()
        length = torch.ones((batch_size, k), dtype=torch.int32, device=dev)
        finished = torch.zeros((batch_size, k), dtype=torch.bool, device=dev)
        h = generator.init_hidden(batch_size * k, v.dtype, dev)
        row0 = torch.arange(batch_size, device=dev)[:, None] * k

        for t in range(c_len - 1):
            prev = model.encoder.embed(tokens[:, :, t].reshape(-1))
            h, out, _ = generator.decode(v, v_mean, prev, h,
                                         att_cache=att_cache, beam=k,
                                         return_features=fused_vocab)
            if fused_vocab:
                w = head.weight.to(out.dtype)
                fused = (vocab_topk.vocab_topk_lse
                         if vocab_topk.supports(*out.shape, w.shape[0], k,
                                                out.dtype)
                         else vocab_topk.vocab_topk_lse_reference)
                top_val, top_word, lse = fused(out, w, head.bias, k)
                top_word = top_word.long()
            else:
                top_val, top_word = vocab_topk.topk_first(out, k)
                lse = None if legacy_logit_scores else \
                    torch.logsumexp(out, dim=-1, keepdim=True)
            step = top_val if legacy_logit_scores else top_val - lse
            step = step.reshape(batch_size, k, k)
            top_word = top_word.reshape(batch_size, k, k)
            # a finished beam continues only by <end>, adding nothing
            done = finished[:, :, None]
            step = torch.where(done, first_only.to(step.dtype), step)
            top_word = torch.where(done, end_id, top_word)
            cand = (logp[:, :, None] + step).reshape(batch_size, k * k)
            top_logp, top_idx = torch.sort(cand, dim=1, descending=True,
                                           stable=True)
            top_logp, top_idx = top_logp[:, :k], top_idx[:, :k]
            beam_idx = top_idx // k                                # [B, k]
            word = top_word.reshape(batch_size, k * k).gather(1, top_idx)
            tokens = tokens.gather(
                1, beam_idx[:, :, None].expand(batch_size, k, c_len))
            tokens[:, :, t + 1] = word
            finished_g = finished.gather(1, beam_idx)
            length = length.gather(1, beam_idx) + (~finished_g).int()
            finished = finished_g | (word == end_id)
            logp = top_logp
            h = _reorder(h, (row0 + beam_idx).reshape(-1))

        # length-normalised score (caption.py:24-26), finished beams first
        norm = logp / (length.to(logp.dtype) - 1 + 1e-6)
        ranked = torch.where(finished, norm, norm + 2 * NEG_INF)
        order = torch.sort(-ranked, dim=1, stable=True).indices
        tokens = tokens.gather(1, order[:, :, None].expand(batch_size, k,
                                                           c_len))
        return tokens, norm.gather(1, order)

    return beam_search


def tokens_to_captions(tokens: np.ndarray, vocab, end_id: int,
                       drop_specials: bool = True) -> List[str]:
    """[B, T] token rows -> caption strings (stop at <end>)."""
    out = []
    for row in np.asarray(tokens):
        words = []
        for tok in row:
            word = vocab.words[int(tok)]
            if int(tok) == end_id and words:
                if not drop_specials:
                    words.append(word)
                break
            if drop_specials and word in ("<start>", "<end>", "<pad>"):
                continue
            words.append(word)
        out.append(" ".join(words))
    return out


def decode_batch(model, batch: Dict[str, torch.Tensor], vocab, k: int = 3,
                 c_len: int = 20, beam_search: Optional[Callable] = None
                 ) -> List[str]:
    """Beam-decode one batch to caption strings (best beam per image)."""
    if beam_search is None:
        beam_search = make_beam_search(model, k, c_len, vocab.start, vocab.end)
    tokens, _ = beam_search(batch)
    return tokens_to_captions(tokens[:, 0].cpu().numpy(), vocab, vocab.end)
