"""Fused vocab head of the beam search: GEMM, exact top-k, logsumexp.

Counterpart of ``vqa_tpu/ops/pallas/vocab_topk.py`` ``vocab_topk_lse``; the
CUDA kernel is ``vqa_tpu_torch/csrc/vocab_topk.cu``. ``logits = h @ w.T + b``
with f32 products and sums (bf16 operands are exact in f32) and the bias
added in f32, then the k largest logits of each row with their vocabulary
indices, ties to the lowest index as ``lax.top_k``, and the row's
logsumexp. The kernel never forms the [R, V] logits: wgmma on 128 x 128
logit tiles that TMA loads into an mbarrier ring, its two consumer
warpgroups in ping-pong so that one's top-k and logsumexp epilogue overlaps
the other's products, over (row band, vocabulary split) units that
:func:`_plan` sizes; a second small kernel merges the splits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vqa_tpu_torch.ops.kernels import _build

# copies of the kernel's constants: H's step (TMA reads 16-byte rows and
# zero-fills the last 64-deep K stage past H), the rows of h and vocabulary
# rows of w of a logit tile, the largest k, and the most vocabulary splits
# (the partial buffers' first dimension)
_H_STEP = 8
_TILE_R = 128
_TILE_V = 128
_MAX_K = 8
_MAX_SPLITS = 64
# the share of a tile's time that its epilogue adds where it overlaps no
# other warpgroup's products
_LONE_UNIT = 0.15


def _plan(rows: int, vocab: int, sms: int) -> Tuple[int, int, int]:
    """(tiles_per_split, splits, grid) for the kernel on a card of ``sms``
    SMs. Work is cut into units of (128-row band, vocabulary split); a block
    takes units in pairs, one per consumer warpgroup, and its two
    warpgroups share its tensor cores, so a block's time is about its units
    times (tiles a split + 1, for the unit's first loads and final merge),
    and a unit left without a partner also pays its epilogue, which then
    overlaps nothing (about 15% of a tile). Picks the tiles a split that
    makes the busiest block's time least, the fewer splits on a tie; the
    grid is one block an SM, at most one per pair of units."""
    bands = -(-rows // _TILE_R)
    n_tiles = -(-vocab // _TILE_V)
    best = None
    for tps in range(1, n_tiles + 1):
        splits = -(-n_tiles // tps)
        if splits > _MAX_SPLITS or -(-n_tiles // splits) != tps:
            continue
        units = bands * splits
        grid = min(sms, -(-units // 2))
        per_block = -(-units // grid)
        cost = (per_block + _LONE_UNIT * (per_block % 2)) * (tps + 1)
        if best is None or cost <= best[0]:
            best = (cost, tps, splits, grid)
    return best[1:]


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of x [R, C] and their int64
    indices, best first, ties to the lowest index (``lax.top_k``'s rule,
    which ``torch.topk`` does not promise): k passes of argmax (the first
    maximal index) and mask."""
    if k > 1:
        x = x.clone()
    vals, idxs = [], []
    for i in range(k):
        a = x.argmax(dim=-1, keepdim=True)
        vals.append(x.gather(-1, a))
        idxs.append(a)
        if i + 1 < k:
            x.scatter_(-1, a, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def vocab_topk_lse_reference(h: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, with the kernel's f32 numbers. h [R, H],
    w [V, H], b [V] -> (vals [R, k] f32, idx [R, k] int32, lse [R, 1] f32)."""
    logits = torch.matmul(h.float(), w.float().t()) + b.float()
    vals, idx = topk_first(logits, k)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, idx.to(torch.int32), lse


def _rules(hidden: int, vocab: int, k: int, dtype: torch.dtype) -> None:
    if not 1 <= k <= min(_MAX_K, vocab):
        raise ValueError(f"vocab_topk_lse: k={k} must lie in [1, "
                         f"{min(_MAX_K, vocab)}]")
    if hidden % _H_STEP:
        raise ValueError(f"vocab_topk_lse: H={hidden} must be a multiple of "
                         f"{_H_STEP}")
    _build.check_dtype("vocab_topk_lse", "h", dtype, torch.bfloat16)


def supports(rows: int, hidden: int, vocab: int, k: int,
             dtype: torch.dtype) -> bool:
    """Whether the kernel takes h [rows, hidden] of ``dtype`` against a
    vocabulary of ``vocab`` rows for the top ``k``."""
    return _build.holds(_rules, hidden, vocab, k, dtype)


def vocab_topk_lse(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k values [R, k] f32, their indices [R, k] int32 and the logsumexp
    [R, 1] f32 of ``h @ w.T + b`` for h [R, H], w [V, H] (torch's Linear
    layout), b [V].

    CPU tensors run :func:`vocab_topk_lse_reference`. CUDA tensors launch
    the kernel, which takes bf16 operands, 1 <= k <= 8, H a multiple of 8
    and V >= k (:func:`supports`), and masks ragged R, V and H; anything
    else raises.
    """
    if h.device.type == "cpu":
        return vocab_topk_lse_reference(h, w, b, k)
    rows, hidden = h.shape
    vocab = w.shape[0]
    if w.shape != (vocab, hidden) or b.shape != (vocab,):
        raise ValueError(f"vocab_topk_lse: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    _rules(hidden, vocab, k, h.dtype)
    for name, t in (("h", h), ("w", w), ("b", b)):
        _build.check_operand("vocab_topk_lse", name, t, torch.bfloat16,
                             h.device)
    for name, t in (("h", h), ("w", w)):
        if t.data_ptr() % 16:   # TMA reads them from 16-byte boundaries
            raise ValueError(f"vocab_topk_lse: {name} must start on a "
                             "16-byte boundary")
    dev = h.device
    _build.library()   # built (or raising) before the card is asked its SMs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tps, splits, grid = _plan(rows, vocab, sms)
    part_v = torch.empty((splits, rows, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, rows, k), dtype=torch.int32, device=dev)
    part_ms = torch.empty((splits, rows, 2), dtype=torch.float32, device=dev)
    vals = torch.empty((rows, k), dtype=torch.float32, device=dev)
    idx = torch.empty((rows, k), dtype=torch.int32, device=dev)
    lse = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    _build.launch("vocab_topk_lse", "vocab_topk_lse_forward", dev, h, w, b,
                  part_v, part_i, part_ms, vals, idx, lse, rows, hidden,
                  vocab, k, tps, grid)
    return vals, idx, lse
