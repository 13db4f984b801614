"""Fused vocab head of the beam search: GEMM, exact top-k, logsumexp.

Counterpart of ``vqa_tpu/ops/pallas/vocab_topk.py`` ``vocab_topk_lse``; the
CUDA kernel is ``vqa_tpu_torch/csrc/vocab_topk.cu``. ``logits = h @ w.T + b``
with f32 products and sums (bf16 operands are exact in f32) and the bias
added in f32, then the k largest logits of each row with their vocabulary
indices, ties to the lowest index as ``lax.top_k``, and the row's
logsumexp. The kernel never forms the [R, V] logits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vqa_tpu_torch.ops.kernels import _build

# the kernel's K step, and its largest k
_TILE_K = 64
_MAX_K = 8
# vocabulary columns per kernel tile
_TILE_V = 128


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


def vocab_topk_lse(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k values [R, k] f32, their indices [R, k] int32 and the logsumexp
    [R, 1] f32 of ``h @ w.T + b`` for h [R, H], w [V, H] (torch's Linear
    layout), b [V].

    CPU tensors run :func:`vocab_topk_lse_reference`. CUDA tensors launch
    the kernel, which takes bf16 operands, 1 <= k <= 8, H a multiple of 64
    and V >= k, and masks ragged R and V; anything else raises.
    """
    if h.device.type == "cpu":
        return vocab_topk_lse_reference(h, w, b, k)
    rows, hidden = h.shape
    vocab = w.shape[0]
    if w.shape != (vocab, hidden) or b.shape != (vocab,):
        raise ValueError(f"vocab_topk_lse: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if not 1 <= k <= min(_MAX_K, vocab):
        raise ValueError(f"vocab_topk_lse: k={k} must lie in [1, "
                         f"{min(_MAX_K, vocab)}]")
    if hidden % _TILE_K:
        raise ValueError(f"vocab_topk_lse: H={hidden} must be a multiple of "
                         f"{_TILE_K}")
    for name, t in (("h", h), ("w", w), ("b", b)):
        _build.check_operand("vocab_topk_lse", name, t, torch.bfloat16,
                             h.device)
    for name, t in (("h", h), ("w", w)):
        if t.data_ptr() % 16:   # the kernel loads their rows by 16 bytes
            raise ValueError(f"vocab_topk_lse: {name} must start on a "
                             "16-byte boundary")
    dev = h.device
    lib = _build.library()
    tiles = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.vocab_topk_lse_plan(rows, vocab, k, ctypes.byref(tiles))
    if rc != 0:
        raise RuntimeError(f"vocab_topk_lse: CUDA error {rc} in the launch "
                           f"plan: {lib.vqa_kernels_error_string(rc).decode()}")
    n_tiles = -(-vocab // _TILE_V)
    splits = -(-n_tiles // tiles.value)
    part_v = torch.empty((splits, rows, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, rows, k), dtype=torch.int32, device=dev)
    part_ms = torch.empty((splits, rows, 2), dtype=torch.float32, device=dev)
    vals = torch.empty((rows, k), dtype=torch.float32, device=dev)
    idx = torch.empty((rows, k), dtype=torch.int32, device=dev)
    lse = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    _build.launch("vocab_topk_lse", "vocab_topk_lse_forward", dev, h, w, b,
                  part_v, part_i, part_ms, vals, idx, lse, rows, hidden,
                  vocab, k, tiles.value)
    return vals, idx, lse
