"""Decode-step attention of the MTL caption-training scan, with the
attention-dropout mask regenerated wherever it is needed.

Counterpart of ``vqa_tpu/ops/pallas/decode_att.py``; the CUDA kernels are
``vqa_tpu_torch/csrc/decode_att.cu``:

- ``decode_att_fwd``: one scan step's attention tail and pooling,
  ``dropout(vp * qp) . k -> softmax over the objects -> att_v = sum_n
  att_n w_n pool_n``, reading ``vp`` and the pooling payload once;
- ``decode_att_bwd``: the reverse step, ``m_n = g_attv . pool_n``, the
  softmax cotangent ``dl`` and ``d_qp_pre = sum_n dl_n keep_n vp_n``;
- ``decode_att_dvp``: the deferred gradient of ``vp``,
  ``sum_t keep_t (dl_t (x) qp_t) * (att_scale * k)``, without the [T, B,
  objs, H] product.

The attention-linear bias is left out of the logits: softmax does not see
it, and its gradient ``sum dl`` is taken outside.

Dropout mask contract. The keep mask is a pure function of (seed, t, b, n,
h): Philox4x32-10 (Salmon et al., SC'11, the Random123 generator) with key
(seed, t + (stream << 16)) and counter (b, n, h // 16, 0). Its four 32-bit
output words give 16 bytes; byte j of word i gates lane
16 * (h // 16) + 4 i + j, which is kept when the byte is below ``thresh``
(keep probability thresh / 256, survivors scaled by 256 / thresh, see
``decode_scan.quantized_keep``). The attention mask is stream 0; the scan's
hidden-state dropouts draw streams 1 and 2 from the same function. Forward,
backward, the deferred reduction and the plain versions therefore see the
same mask whatever the tiling, and a ragged batch needs no tile rule. This
is another Bernoulli stream than the TPU kernels' hardware PRNG, with the
same keep law.

A wrapper given CPU tensors runs the plain version (``*_reference``); given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from vqa_tpu_torch.ops.kernels import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
_MASK32 = 0xFFFFFFFF
LANES = 16                                  # mask bytes of one Philox call
_ACT = {torch.float32: 0, torch.bfloat16: 1}


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * x`` for a 32-bit constant m and an
    int64 tensor of 32-bit values, in int64 without overflow: x is split
    into 16-bit halves, so every partial product stays below 2**48."""
    x_lo, x_hi = x & 0xFFFF, x >> 16
    p_lo, p_hi = x_lo * m, x_hi * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (s >> 32)) & _MASK32, s & _MASK32


def philox4x32_10(counter: Sequence[torch.Tensor], key: Sequence):
    """Philox4x32 with 10 rounds on int64 tensors holding 32-bit words
    (they broadcast against each other): ``counter`` 4 words, ``key`` 2
    words (ints or tensors). Returns the 4 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: int, t: Union[int, Sequence[int], torch.Tensor], rows: int,
              objs: int, H: int, thresh: int, *, stream: int = 0,
              row0: int = 0, device=None) -> torch.Tensor:
    """The uint8 keep mask [rows, objs * H] (1 = kept) of step ``t`` for
    batch rows ``row0 .. row0 + rows``; for a sequence of steps, [len(t),
    rows, objs * H]. ``H`` must be a multiple of 16."""
    if H % LANES:
        raise ValueError(f"keep_mask: H={H} is not a multiple of {LANES}")
    steps = torch.as_tensor(t, dtype=torch.int64, device=device)
    b = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    n = torch.arange(objs, dtype=torch.int64, device=device)
    g = torch.arange(H // LANES, dtype=torch.int64, device=device)
    k1 = ((steps + (stream << 16)) & _MASK32).reshape(-1, 1, 1, 1)
    words = philox4x32_10(
        (b.view(1, -1, 1, 1), n.view(1, 1, -1, 1), g.view(1, 1, 1, -1),
         torch.zeros((), dtype=torch.int64, device=device)),
        (int(seed) & _MASK32, k1))
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    # [T, rows, objs, G, word i, byte j]: lane 16 g + 4 i + j
    bytes_ = (torch.stack(torch.broadcast_tensors(*words), dim=-1)[..., None]
              >> shifts) & 0xFF
    keep = (bytes_ < thresh).to(torch.uint8).reshape(-1, rows, objs * H)
    return keep if steps.dim() else keep[0]


def _masked(x: torch.Tensor, keep: Optional[torch.Tensor], scale: float = 1.0):
    return x if keep is None else torch.where(keep != 0, x * scale,
                                              torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def decode_att_fwd_reference(vp2, pool2, w, qp, k, seed, t, *, objs: int,
                             att_scale: float, thresh: Optional[int],
                             mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`decode_att_fwd` (f32 math). ``mask``
    [B, objs * H] replaces the Philox mask of (seed, t) where given."""
    B, H = qp.shape
    vp = vp2.reshape(B, objs, H).float()
    pool = pool2.reshape(B, objs, -1)
    if thresh is not None and mask is None:
        mask = keep_mask(seed, t, B, objs, H, thresh, device=qp.device)
    keep = None if thresh is None else mask.reshape(B, objs, H)
    joint = _masked(vp * qp.float()[:, None, :], keep, att_scale)
    logits = torch.einsum("bnh,h->bn", joint, k.reshape(H).float())
    att = torch.softmax(logits, dim=1)
    aw = att * w.float() if w is not None else att
    att_v = torch.einsum("bn,bnd->bd", aw, pool.float())
    return att.to(qp.dtype), att_v.to(qp.dtype)


def decode_att_bwd_reference(vp2, pool2, w, att, g_attv, seed, t, *,
                             objs: int, thresh: Optional[int],
                             mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`decode_att_bwd` (f32 math)."""
    B = att.shape[0]
    H = vp2.shape[1] // objs
    pool = pool2.reshape(B, objs, -1)
    m = torch.einsum("bd,bnd->bn", g_attv.float(), pool.float())
    att32 = att.float()
    d_att = m * w.float() if w is not None else m
    dl = att32 * (d_att - torch.sum(att32 * d_att, dim=1, keepdim=True))
    if thresh is not None and mask is None:
        mask = keep_mask(seed, t, B, objs, H, thresh, device=att.device)
    keep = None if thresh is None else mask.reshape(B, objs, H)
    mvp = _masked(vp2.reshape(B, objs, H).float(), keep)
    d_qp_pre = torch.einsum("bn,bnh->bh", dl, mvp)
    dt = g_attv.dtype
    return d_qp_pre.to(dt), m.to(dt), dl.to(dt)


def decode_att_dvp_reference(dls, qps, k, seed, *, objs: int,
                             att_scale: float, thresh: Optional[int],
                             out_dtype: torch.dtype,
                             masks: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`decode_att_dvp` (f32 math). Loops
    over t: the [T, B, objs, H] product would be 11.5 GB in f32 at B=4096,
    T=19. ``masks`` [T, B, objs * H] replaces the Philox masks."""
    T, B, _ = dls.shape
    H = qps.shape[2]
    acc = torch.zeros((B, objs, H), dtype=torch.float32, device=dls.device)
    for t in range(T):
        prod = dls[t].float()[:, :, None] * qps[t].float()[:, None, :]
        if thresh is not None:
            keep = (masks[t] if masks is not None else
                    keep_mask(seed, t, B, objs, H, thresh, device=dls.device))
            prod = _masked(prod, keep.reshape(B, objs, H))
        acc += prod
    out = acc * (att_scale * k.reshape(H).float())
    return out.reshape(B, objs * H).to(out_dtype)


# ---------------------------------------------------------------- kernels


def _check(kernel: str, **operands) -> None:
    for name, (t, dtype, device) in operands.items():
        _build.check_operand(kernel, name, t, dtype, device)


def _pool_kind(pool2: torch.Tensor, act: torch.dtype) -> int:
    """0: the pooling payload has the activations' dtype; 1: int8."""
    if pool2.dtype == torch.int8:
        return 1
    if pool2.dtype != act:
        raise TypeError(f"decode_att: pool2 must be int8 or {act}, "
                        f"got {pool2.dtype}")
    return 0


def _act(kernel: str, x: torch.Tensor) -> int:
    if x.dtype not in _ACT:
        raise TypeError(f"{kernel}: activations must be float32 or bfloat16, "
                        f"got {x.dtype}")
    return _ACT[x.dtype]


def _thresh_arg(thresh: Optional[int]) -> int:
    """The kernels' dropout threshold: 0 means no dropout."""
    if thresh is None:
        return 0
    if not 1 <= thresh <= 255:
        raise ValueError(f"decode_att: thresh={thresh} is not in [1, 255]")
    return int(thresh)


def _shapes(kernel: str, vp2, pool2, B: int, objs: int):
    if vp2.dim() != 2 or pool2.dim() != 2 or vp2.shape[0] != B \
            or pool2.shape[0] != B or vp2.shape[1] % objs \
            or pool2.shape[1] % objs:
        raise ValueError(f"{kernel}: shapes vp2 {tuple(vp2.shape)}, pool2 "
                         f"{tuple(pool2.shape)}, B={B}, objs={objs}")
    H, D = vp2.shape[1] // objs, pool2.shape[1] // objs
    if H % LANES or D % LANES or objs > 64:
        raise ValueError(f"{kernel}: H={H} and D={D} must be multiples of "
                         f"{LANES}, and objs={objs} at most 64")
    return H, D


def decode_att_fwd(vp2, pool2, w, qp, k, seed: int, t: int, *, objs: int,
                   att_scale: float, thresh: Optional[int],
                   emit_mask: bool = False):
    """One decode step's attention tail and pooling.

    vp2 [B, objs * H]; pool2 [B, objs * D] (the int8 payload when ``w``
    [B, objs] is given, else the features); qp [B, H]; k [H] (or [1, H])
    the weight-normed attention-linear kernel; (seed, t) name the Philox
    mask, unused when ``thresh`` is None. Returns (att [B, objs], att_v [B,
    D]) in qp.dtype, and with ``emit_mask`` the uint8 keep mask [B,
    objs * H] too.
    """
    B, H = qp.shape
    if qp.device.type == "cpu":
        out = decode_att_fwd_reference(vp2, pool2, w, qp, k, seed, t,
                                       objs=objs, att_scale=att_scale,
                                       thresh=thresh)
        if emit_mask:
            out += (keep_mask(seed, t, B, objs, H, thresh),)
        return out
    if emit_mask and thresh is None:
        raise ValueError("decode_att_fwd: emit_mask needs a dropout thresh")
    act, dev = _act("decode_att_fwd", qp), qp.device
    Hv, D = _shapes("decode_att_fwd", vp2, pool2, B, objs)
    if Hv != H or k.numel() != H:
        raise ValueError(f"decode_att_fwd: vp2 has H={Hv}, qp {H}, k {k.numel()}")
    ops = dict(vp2=(vp2, qp.dtype, dev), qp=(qp, qp.dtype, dev),
               k=(k, qp.dtype, dev), pool2=(pool2, pool2.dtype, dev))
    if w is not None:
        ops["w"] = (w, qp.dtype, dev)
    _check("decode_att_fwd", **ops)
    kind = _pool_kind(pool2, qp.dtype)
    att = torch.empty((B, objs), dtype=qp.dtype, device=dev)
    att_v = torch.empty((B, D), dtype=qp.dtype, device=dev)
    mask = (torch.empty((B, objs * H), dtype=torch.uint8, device=dev)
            if emit_mask else None)
    _build.launch("decode_att_fwd", "decode_att_fwd", dev, vp2, pool2, w, qp,
                  k, att, att_v, mask, int(seed) & _MASK32, int(t), B, objs,
                  H, D, float(att_scale), _thresh_arg(thresh), act, kind)
    return (att, att_v, mask) if emit_mask else (att, att_v)


def decode_att_bwd(vp2, pool2, w, att, g_attv, seed: int, t: int, *,
                   objs: int, thresh: Optional[int]):
    """Reverse scan step: (d_qp_pre [B, H], m [B, objs], dl [B, objs]) in
    g_attv.dtype. ``d_qp_pre`` is before the (att_scale * k) factor; ``m``
    the pooled-feature cotangent's inner products (d_att = m * w, d_w =
    att * m); ``dl`` the softmax cotangent."""
    if att.device.type == "cpu":
        return decode_att_bwd_reference(vp2, pool2, w, att, g_attv, seed, t,
                                        objs=objs, thresh=thresh)
    B = att.shape[0]
    act, dev, dt = _act("decode_att_bwd", g_attv), att.device, g_attv.dtype
    H, D = _shapes("decode_att_bwd", vp2, pool2, B, objs)
    ops = dict(vp2=(vp2, dt, dev), att=(att, dt, dev),
               g_attv=(g_attv, dt, dev), pool2=(pool2, pool2.dtype, dev))
    if w is not None:
        ops["w"] = (w, dt, dev)
    _check("decode_att_bwd", **ops)
    if att.shape != (B, objs) or g_attv.shape != (B, D):
        raise ValueError(f"decode_att_bwd: att {tuple(att.shape)}, g_attv "
                         f"{tuple(g_attv.shape)}")
    kind = _pool_kind(pool2, dt)
    d_qp = torch.empty((B, H), dtype=dt, device=dev)
    m = torch.empty((B, objs), dtype=dt, device=dev)
    dl = torch.empty((B, objs), dtype=dt, device=dev)
    _build.launch("decode_att_bwd", "decode_att_bwd", dev, vp2, pool2, w, att,
                  g_attv, d_qp, m, dl, int(seed) & _MASK32, int(t), B, objs,
                  H, D, _thresh_arg(thresh), act, kind)
    return d_qp, m, dl


def decode_att_dvp(dls, qps, k, seed: int, *, objs: int, att_scale: float,
                   thresh: Optional[int], out_dtype: torch.dtype):
    """Deferred gradient of vp: ``sum_t keep_t (dl_t (x) qp_t) * (att_scale
    * k)``. dls [T, B, objs]; qps [T, B, H]; k [H]; the mask of step t is
    that of (seed, t). Returns d_vp [B, objs * H] in ``out_dtype``."""
    if dls.device.type == "cpu":
        return decode_att_dvp_reference(dls, qps, k, seed, objs=objs,
                                        att_scale=att_scale, thresh=thresh,
                                        out_dtype=out_dtype)
    T, B, n = dls.shape
    H = qps.shape[2]
    act, dev, dt = _act("decode_att_dvp", dls), dls.device, dls.dtype
    if n != objs or qps.shape[:2] != (T, B) or k.numel() != H or H % LANES:
        raise ValueError(f"decode_att_dvp: dls {tuple(dls.shape)}, qps "
                         f"{tuple(qps.shape)}, k {k.numel()}, objs={objs}")
    if out_dtype not in _ACT:
        raise TypeError(f"decode_att_dvp: out_dtype {out_dtype}")
    _check("decode_att_dvp", dls=(dls, dt, dev), qps=(qps, dt, dev),
           k=(k, dt, dev))
    out = torch.empty((B, objs * H), dtype=out_dtype, device=dev)
    _build.launch("decode_att_dvp", "decode_att_dvp", dev, dls, qps, k, out,
                  int(seed) & _MASK32, T, B, objs, H, float(att_scale),
                  _thresh_arg(thresh), act, _ACT[out_dtype])
    return out
