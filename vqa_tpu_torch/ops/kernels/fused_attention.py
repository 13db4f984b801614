"""Top-down MultiplyAttention and the attention-weighted pooling in one pass.

Counterpart of ``vqa_tpu/ops/pallas/fused_attention.py``
``fused_multiply_attention_pool``; the CUDA kernel is
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
softmax and the pooling are f32.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.kernels import _build

# the kernel holds whole images in a tile of at most 144 rows, one warp a
# softmax of two rows a lane
_MAX_OBJS = 64


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


def fused_multiply_attention_pool(v: torch.Tensor, q: torch.Tensor,
                                  wv: torch.Tensor, bv: torch.Tensor,
                                  wq: torch.Tensor, bq: torch.Tensor,
                                  wl: torch.Tensor, bl: torch.Tensor):
    """(pooled [B, Dv] f32, att [B, N] f32) of the attention above.

    CPU tensors run :func:`multiply_attention_pool_reference`. CUDA tensors
    launch the kernel, which takes bf16 ``v``, ``q``, ``wv`` and ``wq``,
    ``bv``, ``bq``, ``wl`` and ``bl`` in f32 or bf16, N up to 64, and Dv, H
    and Hq multiples of 8; anything else raises. The kernel reads the two
    weights as [H, in] (torch's Linear layout): pass ``weight.t()`` and no
    copy is made.
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
    if not 1 <= objs <= _MAX_OBJS:
        raise ValueError(f"{name}: N={objs} boxes, the kernel takes 1 to "
                         f"{_MAX_OBJS}")
    if v_dim % 8 or hidden % 8 or q_dim % 8:
        raise ValueError(f"{name}: Dv={v_dim}, H={hidden} and Hq={q_dim} "
                         "must be multiples of 8")
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
    for arg, t in (("v", v), ("q", q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    pooled = torch.empty((batch, v_dim), dtype=torch.float32, device=v.device)
    att = torch.empty((batch, objs), dtype=torch.float32, device=v.device)
    _build.launch(name, "fused_attention_forward", v.device, v, q, wv_t, wq_t,
                  bv, bq, wl, bl, pooled, att, batch, objs, v_dim, hidden,
                  q_dim, vec_bf16)
    return pooled, att
