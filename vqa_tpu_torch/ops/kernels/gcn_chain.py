"""The graph-local chain of one ReGAT correlated graph convolution.

Counterpart of ``vqa_tpu/ops/pallas/gcn_chain.py`` ``gcn_chain_fused``; the
CUDA kernel is ``vqa_tpu_torch/csrc/gcn_chain.cu``. Per image, with the
operands in the model's dtype and every product summed in f32:

    o   = out_self + adj @ proj + counts @ bias
    aa  = softmax over i of adj @ alpha_raw      (axis 1 of [B, i, j])
    out = aa @ o

with ``adj = graph != 0`` and ``counts[i, l] = #{j : graph[i, j] == l}``
(label 0 included: bias row 0 is added once for every non-edge). It computes
what the TPU kernel computes, not its block-diagonal packing. In bf16 the
kernel runs both products on the tensor cores behind a TMA ring, on a
persistent grid that :func:`_plan` sizes; f32 keeps one block an image.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vqa_tpu_torch.ops.kernels import _build

# the kernel is built for 36 boxes and up to 16 labels, and copies D in
# 16-byte pieces of whole column pairs
_OBJS, _MAX_LABELS, _D_STEP = 36, 16, 8
# copies of the bf16 kernel's constants: the columns of a D tile, the bytes
# of a ring stage (proj and out_self slots of 48 swizzled 128-byte rows), of
# a resident bias tile, and of what does not depend on the plan (alignment
# slack, double-buffered operands, four staged output tiles, the builders'
# alpha_raw tile and labels, four barriers); the most tiles a column group
# keeps resident, the deepest ring, the consumer warp pairs (a stage serves
# one pair, so the ring's depth is a multiple of them), and the shared
# memory a block may use
_D_TILE = 64
_STAGE_BYTES = 2 * 48 * 128
_BIAS_TILE_BYTES = 16 * 128
_FIXED_BYTES = 1024 + 2 * 2 * 48 * 128 + 4 * 5 * 1024 + 48 * 128 + 36 * 36 + 4 * 8
_MAX_GROUP_TILES = 32
_MAX_STAGES = 8
_PAIRS = 4
_SMEM_LIMIT = 232448


def _smem_bytes(stages: int, tiles_per_group: int) -> int:
    """Dynamic shared memory of the bf16 kernel for a plan."""
    return (_FIXED_BYTES + stages * (_STAGE_BYTES + 16)
            + tiles_per_group * _BIAS_TILE_BYTES)


def _plan(batch: int, d: int, sms: int) -> Tuple[int, int, int, int]:
    """(groups, tiles_per_group, stages, grid) of the bf16 kernel on a card
    of ``sms`` SMs. D is cut into 64-column tiles; the tiles fall into as
    few column groups as keep each group's bias tiles (2 KB each) resident,
    at most 32 (D <= 2048: one group). Block i takes column group
    i % groups and the images i // groups + (grid // groups) q; one block
    an SM, each group given an equal share of them, at most one a (group,
    image). The ring is as deep as the rest of the shared memory allows, up
    to 8 stages, in multiples of the 4 consumer warp pairs."""
    n_tiles = -(-d // _D_TILE)
    groups = -(-n_tiles // _MAX_GROUP_TILES)
    tiles_per_group = -(-n_tiles // groups)
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - _smem_bytes(0, tiles_per_group))
                 // (_STAGE_BYTES + 16)) // _PAIRS * _PAIRS
    per_group = max(1, min(batch, sms // groups))
    return groups, tiles_per_group, stages, groups * per_group


def label_counts(graph: torch.Tensor, num_labels: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """``counts[..., i, l] = #{j : graph[..., i, j] == l}`` in ``dtype``:
    the one-hot label sum, without the one-hot tensor."""
    g = graph.long()
    counts = torch.zeros(*g.shape[:-1], num_labels, dtype=dtype, device=g.device)
    return counts.scatter_add_(-1, g, torch.ones(g.shape, dtype=dtype,
                                                 device=g.device))


def gcn_chain_reference(out_self: torch.Tensor, proj: torch.Tensor,
                        alpha_raw: torch.Tensor, graph: torch.Tensor,
                        bias: torch.Tensor, num_labels: int = 12
                        ) -> torch.Tensor:
    """Plain PyTorch version: the products of operands rounded to the model
    dtype (``out_self``'s), summed as f32 matmuls."""
    dt, f32 = out_self.dtype, torch.float32
    adj = (graph != 0).to(f32)
    o = (out_self.to(f32) + torch.matmul(adj, proj.to(dt).to(f32))
         + torch.matmul(label_counts(graph, num_labels, f32),
                        bias.to(dt).to(f32)))
    aa = torch.softmax(torch.matmul(adj, alpha_raw.to(dt).to(f32)), dim=1)
    return torch.matmul(aa.to(dt).to(f32), o.to(dt).to(f32)).to(dt)


def gcn_chain_fused(out_self: torch.Tensor, proj: torch.Tensor,
                    alpha_raw: torch.Tensor, graph: torch.Tensor,
                    bias: torch.Tensor, num_labels: int = 12) -> torch.Tensor:
    """out_self, proj [B, N, D]; alpha_raw [B, N, N]; graph [B, N, N] int
    labels; bias [num_labels, D] -> [B, N, D] in ``out_self``'s dtype.

    CPU tensors run :func:`gcn_chain_reference`. CUDA tensors launch the
    kernel, which takes bf16 or f32 (alpha_raw and bias are cast to that
    dtype), an int32 graph, N = 36, D a multiple of 8, at most 16 labels and
    16-byte aligned operands; anything else raises.
    """
    if out_self.device.type == "cpu":
        return gcn_chain_reference(out_self, proj, alpha_raw, graph, bias,
                                   num_labels)
    b, n, d = out_self.shape
    if proj.shape != (b, n, d) or alpha_raw.shape != (b, n, n) \
            or graph.shape != (b, n, n) or bias.shape != (num_labels, d):
        raise ValueError(
            f"gcn_chain_fused: shapes out_self {tuple(out_self.shape)}, proj "
            f"{tuple(proj.shape)}, alpha_raw {tuple(alpha_raw.shape)}, graph "
            f"{tuple(graph.shape)}, bias {tuple(bias.shape)}")
    if n != _OBJS or num_labels > _MAX_LABELS or d % _D_STEP:
        raise ValueError(f"gcn_chain_fused: the kernel takes N={_OBJS}, D a "
                         f"multiple of {_D_STEP} and at most {_MAX_LABELS} "
                         f"labels; got N={n}, D={d} and {num_labels} labels")
    dt = out_self.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gcn_chain_fused: out_self must be float32 or "
                        f"bfloat16, got {dt}")
    alpha_raw, bias = alpha_raw.to(dt), bias.to(dt)
    for name, t, want in (("out_self", out_self, dt), ("proj", proj, dt),
                          ("alpha_raw", alpha_raw, dt),
                          ("graph", graph, torch.int32), ("bias", bias, dt)):
        _build.check_operand("gcn_chain_fused", name, t, want, out_self.device)
    for name, t in (("out_self", out_self), ("proj", proj), ("bias", bias)):
        if t.data_ptr() % 16:
            raise ValueError(f"gcn_chain_fused: {name} must be 16-byte aligned")
    out = torch.empty_like(out_self)
    plan = (0, 0, 0, 0)
    if dt == torch.bfloat16:
        _build.library()   # built (or raising) before the card is asked its SMs
        sms = torch.cuda.get_device_properties(out_self.device).multi_processor_count
        plan = _plan(b, d, sms)
    _build.launch("gcn_chain_fused", "gcn_chain_forward", out_self.device,
                  out_self, proj, alpha_raw, graph, bias, out, b, d,
                  num_labels, int(dt == torch.bfloat16), *plan)
    return out
