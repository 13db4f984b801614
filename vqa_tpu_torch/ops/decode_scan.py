"""Teacher-forcing scan of the BUTD caption decoder with a hand-written
backward (counterpart of ``vqa_tpu/ops/decode_scan.py``).

The MTL training step runs the two-cell Up-Down decoder for ``T = c_len - 1``
steps. ``make_butd_caption_scan`` returns ``(scan_fn, reference_fn)``:

- ``scan_fn`` is a ``torch.autograd.Function``. Its forward keeps only the
  small per-step residuals: the two [B, H] carries, the [B, objs] attention
  weights and the [B, D] pooled features. Its backward runs the steps in
  reverse, rebuilding each step's two [B, H]-sized segments from those
  residuals (``torch.autograd.grad`` over the word RNN -> h1 FC -> query
  projection, and over the language RNN), and does the attention tail's
  backward by hand: the only per-step reads of ``v`` (or the int8 payload)
  and of ``vp`` are the fused backward step. The gradient of ``vp`` is one
  reduction after the loop, the attention-linear kernel's and bias's
  gradients are summed by hand and chained through the scalar weight norm,
  and the gradient of ``v`` is one einsum after the loop (dense) or a
  [B, objs] sum ``d_w = sum_t att_t * m_t`` (factored).
- ``reference_fn`` is the same forward under plain autograd, for the tests.

``factored_v`` (the int8 feed): the visual input is ``(q8, w)`` with
``v = w[:, :, None] * q8``, q8 the int8 payload and w = v_att * img_scale.

``pallas_att`` routes each step's attention tail, the reverse step and the
deferred ``d_vp`` to the decode-attention kernels
(``ops/kernels/decode_att.py``; on CPU tensors their plain versions) where
the kernels take the scan's shapes (``decode_att.supports``: H and D
multiples of 16, at most 64 boxes, H and D at most 8192, 16-byte aligned
operands). Otherwise the plain versions run on any device, with the
attention masks drawn once in the forward and kept for the backward.

Dropout follows the 8-bit keep law of ``quantized_keep``: the attention
mask and the two hidden-state masks (``h1`` before the h1 FC, ``h2`` before
the vocab head) come from the counter-based ``keep_mask`` of one 32-bit
``seed`` (streams 0, 1, 2), so the backward sees exactly the forward's masks.
The stream differs from the JAX package's ``fold_in`` keys (same keep law).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from vqa_tpu_torch.ops.kernels import decode_att as da
from vqa_tpu_torch.ops.rnn import gru_step

_WQ = "attention.W_q.main.0."
_LIN = "attention.linear."
# the decoder parameters the scan reads, by their names in the decoder's
# state_dict; the word-RNN segment, the language-RNN segment, the attention
# linear (handled by hand)
SEG_A = ("word_rnn.weight_ih", "word_rnn.bias_ih", "word_rnn.weight_hh",
         "word_rnn.bias_hh", "h1_fcnet.weight", "h1_fcnet.bias",
         _WQ + "weight_v", _WQ + "weight_g", _WQ + "bias")
SEG_B = ("language_rnn.weight_ih", "language_rnn.bias_ih",
         "language_rnn.weight_hh", "language_rnn.bias_hh")
LINEAR = (_LIN + "weight_v", _LIN + "weight_g", _LIN + "bias")
SCAN_PARAMS = SEG_A + SEG_B + LINEAR

STREAM_H1, STREAM_H2 = 1, 2     # keep_mask streams of the hidden dropouts


def wn_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Scalar weight norm ``g * rsqrt(sum(v^2)) * v`` (``WNDense.weight``)."""
    return (g * torch.rsqrt(torch.sum(v * v))) * v


def quantized_keep(keep: float):
    """The 8-bit keep-probability quantization ``(thresh, scale)``: keep is
    thresh / 256 with thresh in [1, 255], survivors are scaled by the same
    quantized 256 / thresh, so dropout stays exactly unbiased."""
    thresh = min(255, max(1, round(keep * 256)))
    return thresh, 256.0 / thresh


def _mm(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w_t.to(x.dtype))


def _drop(x: torch.Tensor, keep: Optional[torch.Tensor], scale: float):
    if keep is None:
        return x
    return torch.where(keep != 0, x * scale, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class _Config:
    """The static part of one scan: widths, dropout laws, routing."""

    def __init__(self, hidden_dim: int, v_dim: int, dropout: float,
                 att_dropout: float, deterministic: bool, pallas_att: bool):
        self.H, self.VD = hidden_dim, v_dim
        self.pallas = pallas_att
        p_drop = 0.0 if deterministic else dropout
        p_att = 0.0 if deterministic else att_dropout
        self.p_thresh, self.p_scale = (quantized_keep(1.0 - p_drop)
                                       if p_drop > 0 else (None, 1.0))
        self.a_thresh, self.a_scale = (quantized_keep(1.0 - p_att)
                                       if p_att > 0 else (None, 1.0))

    def hidden_masks(self, seed: int, T: int, B: int, device):
        """The h1 and h2 keep masks [T, B, H] (None without dropout)."""
        if self.p_thresh is None:
            return [None] * T, [None] * T
        return tuple(list(da.keep_mask(seed, range(T), B, 1, self.H,
                                       self.p_thresh, stream=s, device=device))
                     for s in (STREAM_H1, STREAM_H2))

    def seg_a1(self, P, h1, h2, prev, v_gates, keep1):
        """word RNN -> dropout -> h1 FC -> query projection + ReLU: returns
        (h1', hq, qp). The word RNN's v_mean rows come in as ``v_gates``."""
        H, VD = self.H, self.VD
        wi = P["word_rnn.weight_ih"]
        xi = (_mm(h2, wi[:, :H].t()) + _mm(prev, wi[:, H + VD:].t())
              + v_gates + P["word_rnn.bias_ih"].to(h2.dtype))
        hi = _mm(h1, P["word_rnn.weight_hh"].t()) \
            + P["word_rnn.bias_hh"].to(h1.dtype)
        h1n = gru_step(h1, xi, hi)
        hd = _drop(h1n, keep1, self.p_scale)
        hq = _mm(hd, P["h1_fcnet.weight"].t()) + P["h1_fcnet.bias"].to(hd.dtype)
        wq = wn_kernel(P[_WQ + "weight_v"], P[_WQ + "weight_g"])
        qp = torch.relu(_mm(hq, wq.t()) + P[_WQ + "bias"].to(hq.dtype))
        return h1n, hq, qp

    def seg_b(self, P, h2, hq, att_v, keep2):
        """language RNN -> (h2', dropped pre-logit features)."""
        x = torch.cat([att_v, hq], dim=1)
        xi = _mm(x, P["language_rnn.weight_ih"].t()) \
            + P["language_rnn.bias_ih"].to(x.dtype)
        hi = _mm(h2, P["language_rnn.weight_hh"].t()) \
            + P["language_rnn.bias_hh"].to(h2.dtype)
        h2n = gru_step(h2, xi, hi)
        return h2n, _drop(h2n, keep2, self.p_scale)

    def run(self, P, prev_seq, v_gates, h1, h2, keep1, keep2, tail):
        """The forward loop; ``tail(qp, t) -> (att, att_v)``, ``keep1`` /
        ``keep2`` the hidden masks. Returns the stacked (h1s, h2s, atts,
        att_vs, feats), time-major, with the carries each step starts
        from."""
        T = prev_seq.shape[1]
        ys = []
        for t in range(T):
            h1n, hq, qp = self.seg_a1(P, h1, h2, prev_seq[:, t], v_gates,
                                      keep1[t])
            att, att_v = tail(qp, t)
            h2n, feat = self.seg_b(P, h2, hq, att_v, keep2[t])
            ys.append((h1, h2, att, att_v, feat))
            h1, h2 = h1n, h2n
        return tuple(torch.stack(y) for y in zip(*ys))


def _flat_inputs(pool, w, vp):
    """(vp2 [B, objs * H], pool2 [B, objs * D], w or None) for the kernels."""
    B, objs = vp.shape[:2]
    return (vp.reshape(B, objs * vp.shape[2]).contiguous(),
            pool.reshape(B, -1).contiguous(),
            None if w is None else w.contiguous())


class _Scan(torch.autograd.Function):
    """Forward: the scan without autograd, keeping the per-step residuals.
    Backward: the reverse loop of ``vqa_tpu/ops/decode_scan.py``
    ``_bwd_common``."""

    @staticmethod
    def forward(ctx, cfg: _Config, seed: int, pool, w, vp, v_gates,
                prev_seq, h1_0, h2_0, *params):
        P = dict(zip(SCAN_PARAMS, params))
        B, objs, H = vp.shape
        vp2, pool2, w_ = _flat_inputs(pool, w, vp)
        k = wn_kernel(P[_LIN + "weight_v"], P[_LIN + "weight_g"]).reshape(H)
        att_masks = []
        kernels = cfg.pallas and da.supports(
            objs, H, pool2.shape[1] // objs, vp2.dtype, pool2.dtype,
            aligned=vp2.data_ptr() % 16 == 0 and pool2.data_ptr() % 16 == 0)

        def tail(qp, t):
            if kernels:
                return da.decode_att_fwd(vp2, pool2, w_, qp, k, seed, t,
                                         objs=objs, att_scale=cfg.a_scale,
                                         thresh=cfg.a_thresh)
            mask = (None if cfg.a_thresh is None else
                    da.keep_mask(seed, t, B, objs, H, cfg.a_thresh,
                                 device=vp.device))
            att_masks.append(mask)
            return da.decode_att_fwd_reference(
                vp2, pool2, w_, qp, k, seed, t, objs=objs,
                att_scale=cfg.a_scale, thresh=cfg.a_thresh, mask=mask)

        # the hidden masks are drawn once, [T, B, H] bytes each, and kept
        # for the backward
        keeps = cfg.hidden_masks(seed, prev_seq.shape[1], B, vp.device)
        h1s, h2s, atts, att_vs, feats = cfg.run(P, prev_seq, v_gates, h1_0,
                                                h2_0, *keeps, tail)
        ctx.cfg, ctx.seed, ctx.att_masks, ctx.keeps = cfg, seed, att_masks, keeps
        ctx.kernels = kernels
        ctx.save_for_backward(pool, w, vp, v_gates, prev_seq, h1s, h2s, atts,
                              att_vs, *params)
        return feats

    @staticmethod
    def backward(ctx, d_feats):
        cfg, seed = ctx.cfg, ctx.seed
        (pool, w, vp, v_gates, prev_seq, h1s, h2s, atts, att_vs,
         *params) = ctx.saved_tensors
        P = {n: p.detach().requires_grad_() for n, p in zip(SCAN_PARAMS, params)}
        B, objs, H = vp.shape
        T = prev_seq.shape[1]
        vp2, pool2, w_ = _flat_inputs(pool, w, vp)
        lin_v, lin_g = P[_LIN + "weight_v"].detach(), P[_LIN + "weight_g"].detach()
        k = wn_kernel(lin_v, lin_g).reshape(H)
        keep1, keep2 = ctx.keeps
        dt = vp.dtype
        scale_k = torch.tensor(cfg.a_scale, dtype=dt, device=vp.device) * k.to(dt)
        # sums over steps are kept in f32 and cast to each input's dtype at
        # the end
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in P.items() if n not in LINEAR}
        d_vg = torch.zeros(v_gates.shape, dtype=torch.float32, device=vp.device)
        d_w = torch.zeros((B, objs), dtype=torch.float32, device=vp.device)
        d_k = torch.zeros(H, dtype=torch.float32, device=vp.device)
        d_b = torch.zeros((), dtype=torch.float32, device=vp.device)
        d_h1, d_h2 = torch.zeros_like(h1s[0]), torch.zeros_like(h2s[0])
        d_prevs: List[torch.Tensor] = [None] * T
        dls, qps, g_attvs = [None] * T, [None] * T, [None] * T
        for t in reversed(range(T)):
            with torch.enable_grad():
                h1_in = h1s[t].detach().requires_grad_()
                h2_in = h2s[t].detach().requires_grad_()
                prev_t = prev_seq[:, t].detach().requires_grad_()
                vg = v_gates.detach().requires_grad_()
                h1n, hq, qp = cfg.seg_a1(P, h1_in, h2_in, prev_t, vg, keep1[t])
                hq_in = hq.detach().requires_grad_()
                av_in = att_vs[t].detach().requires_grad_()
                h2n, feat = cfg.seg_b(P, h2_in, hq_in, av_in, keep2[t])
                *dP_b, d_h2_b, d_hq, g_attv = torch.autograd.grad(
                    (h2n, feat), [P[n] for n in SEG_B] + [h2_in, hq_in, av_in],
                    (d_h2, d_feats[t]))
            g_attv = g_attv.contiguous()
            if ctx.kernels:
                d_qp_pre, m, dl = da.decode_att_bwd(
                    vp2, pool2, w_, atts[t], g_attv, seed, t, objs=objs,
                    thresh=cfg.a_thresh)
            else:
                d_qp_pre, m, dl = da.decode_att_bwd_reference(
                    vp2, pool2, w_, atts[t], g_attv, seed, t, objs=objs,
                    thresh=cfg.a_thresh, mask=ctx.att_masks[t])
            if w is not None:
                d_w += atts[t].float() * m.float()
            qp_d = qp.detach()
            d_k += torch.einsum("bh,bh->h", qp_d.float(), d_qp_pre.float())
            d_b += dl.float().sum()
            d_qp = d_qp_pre * scale_k
            with torch.enable_grad():
                *dP_a, d_h1, d_h2_a, d_prevs[t], d_vg_t = torch.autograd.grad(
                    (h1n, hq, qp),
                    [P[n] for n in SEG_A] + [h1_in, h2_in, prev_t, vg],
                    (d_h1, d_hq, d_qp))
            for n, g in zip(SEG_A + SEG_B, dP_a + dP_b):
                acc[n] += g.float()
            d_h2 = d_h2_a + d_h2_b
            d_vg += d_vg_t.float()
            dls[t], qps[t], g_attvs[t] = dl, qp_d, g_attv

        # the attention linear: kernel and bias gradients summed above,
        # chained through the scalar weight norm
        with torch.enable_grad():
            lv, lg = lin_v.requires_grad_(), lin_g.requires_grad_()
            d_lin_v, d_lin_g = torch.autograd.grad(
                wn_kernel(lv, lg), (lv, lg),
                (cfg.a_scale * d_k).to(lv.dtype).reshape(lv.shape))
        lin_b = P[_LIN + "bias"]
        grads = {n: acc[n].to(P[n].dtype) for n in SEG_A + SEG_B}
        grads.update({_LIN + "weight_v": d_lin_v, _LIN + "weight_g": d_lin_g,
                      _LIN + "bias": d_b.reshape(lin_b.shape).to(lin_b.dtype)})
        # the deferred gradient of vp: one reduction over the steps
        dls, qps = torch.stack(dls), torch.stack(qps)
        if ctx.kernels:
            d_vp = da.decode_att_dvp(dls, qps, k.to(dls.dtype), seed, objs=objs,
                                     att_scale=cfg.a_scale, thresh=cfg.a_thresh,
                                     out_dtype=vp.dtype)
        else:
            masks = (None if cfg.a_thresh is None
                     else torch.stack(ctx.att_masks))
            d_vp = da.decode_att_dvp_reference(
                dls, qps, k, seed, objs=objs, att_scale=cfg.a_scale,
                thresh=cfg.a_thresh, out_dtype=vp.dtype, masks=masks)
        if w is None:
            # the deferred gradient of v: one contraction over the steps
            d_pool = torch.einsum("tbn,tbd->bnd", atts, torch.stack(g_attvs)
                                  ).to(pool.dtype)
            d_w_out = None
        else:
            d_pool, d_w_out = None, d_w.to(w.dtype)
        return (None, None, d_pool, d_w_out, d_vp.reshape(vp.shape),
                d_vg.to(v_gates.dtype), torch.stack(d_prevs, dim=1), d_h1,
                d_h2, *(grads[n] for n in SCAN_PARAMS))


def make_butd_caption_scan(*, hidden_dim: int, v_dim: int, dropout: float,
                           att_dropout: float, deterministic: bool,
                           factored_v: bool = False, pallas_att: bool = False):
    """``(scan_fn, reference_fn)`` for one decoder configuration, both with
    the signature ``(P, v, vp, v_gates, prev_seq, h1_0, h2_0, seed) -> feats
    [T, B, H]``, or ``(P, q8, w, vp, ...)`` with ``factored_v``:

    - ``P``: the decoder parameters named in :data:`SCAN_PARAMS` (the
      decoder's state_dict names);
    - ``v`` [B, objs, v_dim] the attended features (or the int8 payload
      ``q8`` and the weights ``w`` [B, objs]); ``vp`` [B, objs, H] their
      attention projection (``project_v``); ``v_gates`` [B, 3H] the word
      RNN's v_mean rows (``hoisted_gates``);
    - ``prev_seq`` [B, T, embed] the embedded previous tokens; ``h1_0``,
      ``h2_0`` [B, H] the initial states; ``seed`` the 32-bit dropout seed
      (unused when ``deterministic``).

    ``scan_fn`` has the hand-written backward; ``reference_fn`` is the same
    forward under plain autograd, with the same masks and, as the JAX
    package's XLA path, the attention-linear bias in the logits.
    """
    cfg = _Config(hidden_dim, v_dim, dropout, att_dropout, deterministic,
                  pallas_att)

    def reference(P, vis, vp, v_gates, prev_seq, h1_0, h2_0, seed):
        B, objs, H = vp.shape
        dt = vp.dtype

        def tail(qp, t):
            joint = vp * qp[:, None, :]
            if cfg.a_thresh is not None:
                keep = da.keep_mask(seed, t, B, objs, H, cfg.a_thresh,
                                    device=vp.device).reshape(B, objs, H)
                joint = _drop(joint, keep, cfg.a_scale)
            k = wn_kernel(P[_LIN + "weight_v"], P[_LIN + "weight_g"])
            logits = _mm(joint, k.t())[..., 0] + P[_LIN + "bias"].to(dt)
            att = torch.softmax(logits, dim=1)
            if isinstance(vis, tuple):
                q8, w = vis
                return att, torch.einsum("bn,bnd->bd", att * w, q8.to(dt))
            return att, torch.einsum("bn,bnd->bd", att, vis)

        keeps = cfg.hidden_masks(seed, prev_seq.shape[1], B, vp.device)
        return cfg.run(P, prev_seq, v_gates, h1_0, h2_0, *keeps, tail)[4]

    def params(P: Dict[str, torch.Tensor]):
        return [P[n] for n in SCAN_PARAMS]

    if factored_v:
        def reference_fn(P, q8, w, vp, v_gates, prev_seq, h1_0, h2_0, seed):
            return reference(P, (q8, w), vp, v_gates, prev_seq, h1_0, h2_0,
                             seed)

        def scan_fn(P, q8, w, vp, v_gates, prev_seq, h1_0, h2_0, seed):
            return _Scan.apply(cfg, int(seed), q8, w, vp, v_gates, prev_seq,
                               h1_0, h2_0, *params(P))
    else:
        def reference_fn(P, v, vp, v_gates, prev_seq, h1_0, h2_0, seed):
            return reference(P, v, vp, v_gates, prev_seq, h1_0, h2_0, seed)

        def scan_fn(P, v, vp, v_gates, prev_seq, h1_0, h2_0, seed):
            return _Scan.apply(cfg, int(seed), v, None, vp, v_gates, prev_seq,
                               h1_0, h2_0, *params(P))
    return scan_fn, reference_fn
