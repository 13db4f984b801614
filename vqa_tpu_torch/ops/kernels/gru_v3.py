"""Last hidden state of a 1-layer GRU from raw inputs, the input product
``emb_t @ wi + bi`` inside the kernel.

Counterpart of ``vqa_tpu/ops/pallas/gru_v3.py`` ``gru_last_state_v3``; the
CUDA kernel is ``vqa_tpu_torch/csrc/gru.cu``, v1's kernel with the input
product folded in: each chunk's input stages bring the step's embedding
rows and the chunk's rows of the gate-major input weight by TMA. TMA needs
16-byte row pitches, so the wrapper pads E with zeros to a multiple of 8
(``E8``; a copy of ``emb`` unless E already is one, ~0.1 GB at B=16384,
T=10, E=300, whose time counts in the kernel's) and the TMA zero-fills each
64-deep K tile past ``E8``. The input gates stay f32: unlike the v2 route, where
the input GEMM's output ``xi`` is rounded to the activation dtype before
the kernel reads it, v3 adds the f32 product and ``bi`` straight into the
gates, so the two differ by that rounding. Like the TPU kernel it is a
library kernel: no model path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqa_tpu_torch.ops.kernels import _build
from vqa_tpu_torch.ops.kernels.gru_v2 import (
    check_recurrent, gru_last_state_v2_reference, launch_plan, supports)

# TMA's 16-byte row pitch in bf16: emb and the input weight are zero-padded
# along E to a multiple of it
_E_STEP = 8


def gru_last_state_v3_reference(emb: torch.Tensor, wi: torch.Tensor,
                                bi: torch.Tensor, wh: torch.Tensor,
                                bh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. emb [B, T, E], wi [E, 3H], bi [3H], wh [H, 3H],
    bh [3H] -> [B, H] f32. The input gates are the f32 product plus the f32
    bias, in the TPU kernel's order; the recurrence is v2's."""
    xi = torch.matmul(emb.float(), wi.float()) + bi.float()
    return gru_last_state_v2_reference(xi, wh, bh)


def gru_last_state_v3(emb: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """Last GRU state [B, H] f32 of the inputs emb [B, T, E] under input
    weights wi [E, 3H], bi [3H] and recurrent weights wh [H, 3H], bh [3H].

    CPU tensors run :func:`gru_last_state_v3_reference`. CUDA tensors launch
    the kernel, which takes bf16 operands, any E, any B >= 1 and H a
    multiple of 32, with ``gru_last_state_v2``'s cluster plan; anything else
    raises. ``emb`` is zero-padded along
    E to a multiple of 8 where it is not one already, and ``wi`` is copied
    gate-major and zero-padded alike, so any layout of it will do.
    """
    if emb.device.type == "cpu":
        return gru_last_state_v3_reference(emb, wi, bi, wh, bh)
    name = "gru_last_state_v3"
    batch, t_len, e_dim = emb.shape
    gates = wh.shape[1]
    e8 = -(-e_dim // _E_STEP) * _E_STEP
    w_gk = check_recurrent(name, batch, t_len, gates, wh, bh, emb.device)
    if wi.shape != (e_dim, gates) or bi.shape != (gates,):
        raise ValueError(f"{name}: shapes emb {tuple(emb.shape)}, wi "
                         f"{tuple(wi.shape)}, bi {tuple(bi.shape)}")
    if wi.device != emb.device:
        raise ValueError(f"{name}: wi is on {wi.device}, not {emb.device}")
    if wi.dtype != torch.bfloat16:
        raise TypeError(f"{name}: wi must be torch.bfloat16, got {wi.dtype}")
    # the input weight gate-major ([3H, E8]), zero past E
    wi_t = torch.zeros((gates, e8), dtype=torch.bfloat16, device=emb.device)
    wi_t[:, :e_dim] = wi.t()
    for arg, t in (("emb", emb), ("wi", wi_t), ("bi", bi)):
        _build.check_operand(name, arg, t, torch.bfloat16, emb.device)
    emb8 = F.pad(emb, (0, e8 - e_dim)) if e8 != e_dim else emb
    if emb8.data_ptr() % 16:
        raise ValueError(f"{name}: emb must be 16-byte aligned (TMA)")
    hidden = wh.shape[0]
    out = torch.empty((batch, hidden), dtype=torch.float32, device=emb.device)
    cluster, h16 = launch_plan(emb.device, batch, hidden, v3=True)
    _build.launch(name, "gru_last_state_v3_forward", emb.device, emb8, wi_t,
                  bi, w_gk, bh, out, h16, batch, t_len, hidden, e_dim, e8,
                  cluster)
    return out
