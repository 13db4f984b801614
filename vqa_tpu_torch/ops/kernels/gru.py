"""Last hidden state of a 1-layer GRU, the whole sequence in one launch.

Counterpart of ``vqa_tpu/ops/pallas/gru.py`` ``gru_last_state``. It
computes what ``gru_last_state_v2`` computes, with the same gate math and
rounding points (gate order r, z, n; ``xi`` and ``bh`` upcast to f32; the
state carried in f32 and rounded to ``wh``'s dtype only as the product
operand), so it launches the same kernel, ``vqa_tpu_torch/csrc/gru.cu``
(one launch for all T steps, clusters of blocks sharing a 64-row state
tile; see :mod:`vqa_tpu_torch.ops.kernels.gru_v2`), counted under its own
name. Like the TPU kernel it is a library kernel: no model path calls it.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.kernels.gru_v2 import (
    gru_last_state_v2_reference, sequence, supports)


def gru_last_state_reference(xi: torch.Tensor, wh: torch.Tensor,
                             bh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. xi [B, T, 3H], wh [H, 3H], bh [3H] -> [B, H]
    f32: the recurrence of ``gru_last_state_v2_reference``."""
    return gru_last_state_v2_reference(xi, wh, bh)


def gru_last_state(xi: torch.Tensor, wh: torch.Tensor,
                   bh: torch.Tensor) -> torch.Tensor:
    """Last GRU state [B, H] f32 of xi [B, T, 3H] under recurrent weights
    wh [H, 3H] and bias bh [3H].

    CPU tensors run :func:`gru_last_state_reference`. CUDA tensors launch
    the sequence kernel of ``gru_last_state_v2`` (the same function, with
    its cluster plan), which takes bf16 operands, any B >= 1 and H a
    multiple of 32; anything else raises. Pass ``weight_hh.t()`` as ``wh``
    and no copy is made.
    """
    if xi.device.type == "cpu":
        return gru_last_state_reference(xi, wh, bh)
    return sequence("gru_last_state", xi, wh, bh)
