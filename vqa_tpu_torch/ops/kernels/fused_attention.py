"""Top-down MultiplyAttention and the attention-weighted pooling in one call.

Counterpart of ``vqa_tpu/ops/pallas/fused_attention.py``
``fused_multiply_attention_pool``; the CUDA kernels are
``vqa_tpu_torch/csrc/fused_attention.cu``:

    vp     = relu(v @ wv + bv)            [B, N, H]
    qp     = relu(q @ wq + bq)            [B, H]
    logits = (vp * qp[:, None, :]) @ wl + bl
    att    = softmax_N(logits)            [B, N]
    pooled = sum_N att * v                [B, Dv]

The [B, N, H] activations never reach device memory. The caller folds
weight normalization into the weights (``g / ||v||`` times ``v``, transposed
to [in, out]), as for the TPU kernel. Like it, this is a library kernel: no
model path of the port calls it. Rounding points are the TPU kernel's: the
products accumulate in f32, and the biases, the gate, the logits, the
softmax and the pooling are f32; qp is never rounded below f32.

One call is two launches, counted as one: a small kernel writes qp [B, H]
(and f32 copies of bv and wl) to a scratch tensor, then a persistent kernel
on wgmma, in thread block clusters along H that share each v stage by TMA
multicast, computes the rest over M tiles of whole images. :func:`_plan`
sizes it from what the kernel reports of its shared memory and of the card
(``fused_attention_query``). ``chip_smoke.py`` phase 12 times it at the
serving shape beside the unfused bf16 module and its bound (PERF.md).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from vqa_tpu_torch.ops.kernels import _build

# the kernel's H columns of a block's pass and rows of an M tile (its
# kTileN and kTileM; its entry refuses a plan that disagrees), and the
# cluster sizes it takes, largest first: at H=1024 clusters of 4 blocks
# taking two column tiles each were faster than 8 taking one (PERF.md)
_TILE_N = 128
_TILE_M = 256
_CLUSTERS = (4, 2, 1)
# the most boxes an image may have: one image fills an M tile
_MAX_OBJS = _TILE_M


class Card(NamedTuple):
    """What ``fused_attention_query`` reports: the attention kernel's
    dynamic shared memory, ``fixed`` bytes plus ``per_stage`` bytes a ring
    stage, the most a block may take on the card, and its SM count."""
    fixed: int
    per_stage: int
    smem_limit: int
    sms: int


_CARDS: Dict[int, Card] = {}


def _card(device: torch.device) -> Card:
    """The kernel's and the card's answers for ``device``, asked once the
    kernel library is built (or has raised)."""
    key = device.index or 0
    if key not in _CARDS:
        vals = [ctypes.c_int(0) for _ in Card._fields]
        _build.query("fused_multiply_attention_pool", "fused_attention_query",
                     device, *(ctypes.addressof(v) for v in vals))
        _CARDS[key] = Card(*(v.value for v in vals))
    return _CARDS[key]


def _plan(batch: int, objs: int, hidden: int,
          card: Card) -> Tuple[int, int, int, int, int]:
    """(images, cluster, passes, stages, grid) of the attention kernel. An
    M tile of 256 rows holds floor(256 / N) whole images. H falls into
    128-column tiles; a cluster is the largest of 4, 2, 1 blocks that
    divides their count, and each block takes ``passes`` of them. The ring
    is as deep as the card's shared memory allows. One cluster an M tile,
    at most one block an SM; the kernel cuts the grid further to the
    clusters the card holds at once."""
    images = _TILE_M // objs
    col_tiles = -(-hidden // _TILE_N)
    cluster = next(c for c in _CLUSTERS if col_tiles % c == 0)
    stages = (card.smem_limit - card.fixed) // card.per_stage
    tiles = -(-batch // images)
    return (images, cluster, col_tiles // cluster, stages,
            min(tiles, card.sms // cluster) * cluster)


def multiply_attention_pool_reference(v: torch.Tensor, q: torch.Tensor,
                                      wv: torch.Tensor, bv: torch.Tensor,
                                      wq: torch.Tensor, bq: torch.Tensor,
                                      wl: torch.Tensor, bl: torch.Tensor):
    """Plain PyTorch version in f32: v [B, N, Dv], q [B, Hq], wv [Dv, H],
    bv [H], wq [Hq, H], bq [H], wl [H, 1], bl [1] -> (pooled [B, Dv],
    att [B, N])."""
    f32 = torch.float32
    vp = torch.relu(torch.matmul(v.to(f32), wv.to(f32)) + bv.to(f32))
    qp = torch.relu(torch.matmul(q.to(f32), wq.to(f32)) + bq.to(f32))
    logits = torch.einsum("bnh,h->bn", vp * qp[:, None, :],
                          wl[:, 0].to(f32)) + bl.to(f32)[0]
    att = torch.softmax(logits, dim=1)
    pooled = torch.einsum("bn,bnd->bd", att, v.to(f32))
    return pooled, att


def _rules(objs: int, v_dim: int, hidden: int, q_dim: int,
           dtype: torch.dtype) -> None:
    name = "fused_multiply_attention_pool"
    if not 1 <= objs <= _MAX_OBJS:
        raise ValueError(f"{name}: N={objs} boxes, the kernel takes 1 to "
                         f"{_MAX_OBJS}")
    if v_dim % 8 or hidden % 8 or q_dim % 8:
        raise ValueError(f"{name}: Dv={v_dim}, H={hidden} and Hq={q_dim} "
                         "must be multiples of 8")
    _build.check_dtype(name, "v", dtype, torch.bfloat16)


def supports(batch: int, objs: int, v_dim: int, hidden: int, q_dim: int,
             dtype: torch.dtype) -> bool:
    """Whether the kernels take v [batch, objs, v_dim] of ``dtype`` with a
    question of ``q_dim`` and an attention of width ``hidden``."""
    return _build.holds(_rules, objs, v_dim, hidden, q_dim, dtype)


def fused_multiply_attention_pool(v: torch.Tensor, q: torch.Tensor,
                                  wv: torch.Tensor, bv: torch.Tensor,
                                  wq: torch.Tensor, bq: torch.Tensor,
                                  wl: torch.Tensor, bl: torch.Tensor):
    """(pooled [B, Dv] f32, att [B, N] f32) of the attention above.

    CPU tensors run :func:`multiply_attention_pool_reference`. CUDA tensors
    launch the kernels, which take bf16 ``v``, ``q``, ``wv`` and ``wq``,
    ``bv``, ``bq``, ``wl`` and ``bl`` in f32 or bf16, N up to 256, and Dv,
    H and Hq multiples of 8 (:func:`supports`); anything else raises. The
    kernels read the two weights as [H, in] (torch's Linear layout): pass
    ``weight.t()`` and no copy is made.
    """
    if v.device.type == "cpu":
        return multiply_attention_pool_reference(v, q, wv, bv, wq, bq, wl, bl)
    name = "fused_multiply_attention_pool"
    batch, objs, v_dim = v.shape
    q_dim, hidden = wq.shape
    if q.shape != (batch, q_dim) or wv.shape != (v_dim, hidden) \
            or bv.shape != (hidden,) or bq.shape != (hidden,) \
            or wl.shape != (hidden, 1) or bl.shape != (1,):
        raise ValueError(
            f"{name}: shapes v {tuple(v.shape)}, q {tuple(q.shape)}, wv "
            f"{tuple(wv.shape)}, bv {tuple(bv.shape)}, wq {tuple(wq.shape)}, "
            f"bq {tuple(bq.shape)}, wl {tuple(wl.shape)}, bl {tuple(bl.shape)}")
    _rules(objs, v_dim, hidden, q_dim, v.dtype)
    wv_t, wq_t = wv.t().contiguous(), wq.t().contiguous()
    for arg, t in (("v", v), ("q", q), ("wv", wv_t), ("wq", wq_t)):
        _build.check_operand(name, arg, t, torch.bfloat16, v.device)
    vec_bf16 = 0
    vecs = (("bv", bv), ("bq", bq), ("wl", wl), ("bl", bl))
    for bit, (arg, t) in enumerate(vecs):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: {arg} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        _build.check_operand(name, arg, t, t.dtype, v.device)
        vec_bf16 |= (t.dtype == torch.bfloat16) << bit
    for arg, t in (("v", v), ("q", q), ("wv", wv_t), ("wq", wq_t)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    plan = _plan(batch, objs, hidden, _card(v.device))
    # qp [B, Hp] and f32 bv, wl [Hp], Hp = H in whole 128-column tiles
    h_pad = -(-hidden // _TILE_N) * _TILE_N
    qp = torch.empty(((batch + 2) * h_pad,), dtype=torch.float32,
                     device=v.device)
    pooled = torch.empty((batch, v_dim), dtype=torch.float32, device=v.device)
    att = torch.empty((batch, objs), dtype=torch.float32, device=v.device)
    _build.launch(name, "fused_attention_forward", v.device, v, q, wv_t, wq_t,
                  bv, bq, wl, bl, qp, pooled, att, batch, objs, v_dim, hidden,
                  q_dim, vec_bf16, *plan)
    return pooled, att
