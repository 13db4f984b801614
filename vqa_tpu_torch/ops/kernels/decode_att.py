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

The forward kernel streams each row's qp, vp and payload by 1-D bulk copies
through an mbarrier ring on a persistent grid, so a row's payload is in
flight while its logits and softmax run (0.2794 ms at B=4096, 0.0470 ms at
B=512: ``chip_smoke.py``, NVIDIA H100 80GB HBM3, 700 W; PERF.md). Its
operands must start on 16-byte boundaries, and H and D stay at most
``MAX_FWD_WIDTH``. The deferred reduction stages each row's qp and dl once
in a ring of its own and gives each thread a lane group and several boxes
(:func:`_dvp_plan`); its qps must start on a 16-byte boundary.

A wrapper given CPU tensors runs the plain version (``*_reference``); given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from vqa_tpu_torch.ops.kernels import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
_MASK32 = 0xFFFFFFFF
LANES = 16                                  # mask bytes of one Philox call
# the forward kernel's widest H and D (a lane's registers for its qp * k
# groups and its pooling sums)
MAX_FWD_WIDTH = 8192
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


def philox_draws(batch: int, objs: int, H: int, steps: int = 1) -> int:
    """Philox4x32-10 calls that the masks of ``steps`` decode steps take: one
    a (row, box, 16-lane group) a step. The forward and backward kernels
    draw one step's masks, the deferred reduction all T steps'."""
    return batch * objs * (H // LANES) * steps


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
    if H > MAX_FWD_WIDTH or D > MAX_FWD_WIDTH:
        raise ValueError(f"decode_att_fwd: H={H} and D={D} must be at most "
                         f"{MAX_FWD_WIDTH}")
    for name, x in (("vp2", vp2), ("pool2", pool2), ("qp", qp)):
        if x.data_ptr() % 16:   # the bulk copies read from 16-byte boundaries
            raise ValueError(f"decode_att_fwd: {name} must start on a "
                             "16-byte boundary")
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


# the deferred reduction's launch: 256 consumer threads a block, two blocks
# an SM, at most 4 boxes a thread (16 f32 sums each), about 16 KB of qp a
# ring stage, 2-4 stages within 100 KB a block
_DVP_THREADS, _DVP_BLOCKS_PER_SM, _DVP_MAX_BOXES = 256, 2, 4
_DVP_STAGE_TARGET, _DVP_MAX_STAGES, _DVP_BLOCK_SMEM = 16384, 4, 100 * 1024


def _round128(x: int) -> int:
    return -(-x // 128) * 128


def _dl_stride(objs: int, itemsize: int) -> int:
    """Bytes of one step's dl row in a stage: the row and its offset in its
    first 4-byte word, padded to 16."""
    return -(-(objs * itemsize + 4) // 16) * 16


def _dvp_items(objs: int, H: int, nb: int, gc: int) -> Tuple[int, int, int]:
    """(box sets an item, group slices a row, box-set slices a row): the
    kernel's block items (``dvp_shape`` in the CUDA source). A row's G = H /
    16 groups fall into slices of ``gc``, its ``ceil(objs / nb)`` box sets
    into slices of ``256 // gc``; an item is one of each."""
    sc = _DVP_THREADS // gc
    return sc, -(-(H // LANES) // gc), -(-(-(-objs // nb)) // sc)


def _dvp_plan(batch: int, objs: int, H: int, T: int, itemsize: int,
              sms: int) -> Tuple[int, int, int, int, int]:
    """(nb, gc, tc, stages, grid) of the deferred-reduction kernel.

    A thread owns one 16-lane group and ``nb`` boxes; a block item is one
    batch row's slice of ``gc`` groups (all of them up to H=4096) by
    ``256 // gc`` sets of ``nb`` boxes, so a row is
    ``ceil(G / gc) * ceil(ceil(objs / nb) / (256 // gc))`` items. ``nb`` is
    the one that leaves the fewest thread slots idle, the largest on a tie
    (qp's lanes, unpacked once a step, serve more boxes). A ring stage holds
    ``tc`` steps of the slice's qp (about 16 KB) and the row's dl; the grid
    is two blocks an SM, at most one an item."""
    gc = min(H // LANES, _DVP_THREADS)
    best = None
    for nb in range(_DVP_MAX_BOXES, 0, -1):
        _, g_items, s_items = _dvp_items(objs, H, nb, gc)
        slots = g_items * s_items * _DVP_THREADS * nb
        if best is None or slots < best[0]:
            best = (slots, nb, g_items * s_items)
    _, nb, per_row = best
    row_bytes = gc * LANES * itemsize
    tc = max(1, min(max(T, 1), _DVP_STAGE_TARGET // row_bytes))
    stage = _round128(tc * row_bytes) + _round128(tc * _dl_stride(objs, itemsize))
    stages = max(2, min(_DVP_MAX_STAGES, _DVP_BLOCK_SMEM // stage))
    grid = max(1, min(batch * per_row, _DVP_BLOCKS_PER_SM * sms))
    return nb, gc, tc, stages, grid


def _dvp_smem_bytes(objs: int, gc: int, tc: int, stages: int,
                    itemsize: int) -> int:
    """Dynamic shared memory of the deferred-reduction kernel for a plan."""
    stage = (_round128(tc * gc * LANES * itemsize)
             + _round128(tc * _dl_stride(objs, itemsize)))
    return 128 + stages * (stage + 16)


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
    if objs > 64:
        raise ValueError(f"decode_att_dvp: objs={objs} must be at most 64")
    if qps.data_ptr() % 16:   # the bulk copies read from 16-byte boundaries
        raise ValueError("decode_att_dvp: qps must start on a 16-byte "
                         "boundary")
    thresh_arg = _thresh_arg(thresh)
    out = torch.empty((B, objs * H), dtype=out_dtype, device=dev)
    _build.library()   # built (or raising) before the card is asked its SMs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = _dvp_plan(B, objs, H, T, dls.element_size(), sms)
    _build.launch("decode_att_dvp", "decode_att_dvp", dev, dls, qps, k, out,
                  int(seed) & _MASK32, T, B, objs, H, float(att_scale),
                  thresh_arg, act, _ACT[out_dtype], *plan)
    return out
