"""Last hidden state of a 1-layer GRU, the whole sequence in one launch.

Counterpart of ``vqa_tpu/ops/pallas/gru.py`` ``gru_last_state``; the CUDA
kernel is ``vqa_tpu_torch/csrc/gru.cu`` (shared with
:mod:`vqa_tpu_torch.ops.kernels.gru_v3`). It computes what
``gru_last_state_v2`` computes, with the gate math and rounding points of
``ops/kernels/gru_v2.py`` (gate order r, z, n; ``xi`` and ``bh`` upcast to
f32; the state carried in f32 and rounded to ``wh``'s dtype only as the
product operand), so the two agree on the same inputs. What sets it apart:
one launch for all T steps, a block owning 64 batch rows across every
step, its bf16 state resident in shared memory as the A operand of wgmma,
the recurrent weight streamed by TMA through an mbarrier ring in chunks of
32 hidden units (3 x 32 gate rows). Like the TPU kernel it is a library
kernel: no model path calls it.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.kernels import _build
from vqa_tpu_torch.ops.kernels.gru_v2 import gru_last_state_v2_reference

# hidden units of one warpgroup's chunk in the kernel (kWgJ): H must be a
# multiple
_CHUNK_J = 32


def gru_last_state_reference(xi: torch.Tensor, wh: torch.Tensor,
                             bh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. xi [B, T, 3H], wh [H, 3H], bh [3H] -> [B, H]
    f32: the recurrence of ``gru_last_state_v2_reference``."""
    return gru_last_state_v2_reference(xi, wh, bh)


def check_recurrent(name: str, batch: int, t_len: int, gates: int,
                    wh: torch.Tensor, bh: torch.Tensor,
                    device: torch.device) -> torch.Tensor:
    """Validate the recurrent operands of the sequence kernels; returns the
    weight gate-major ([3H, H], torch's ``weight_hh`` layout). An H whose
    bf16 state and ring do not fit in shared memory (H=2048 and above) is
    refused by the launch itself, before the kernel runs."""
    hidden = wh.shape[0]
    if wh.shape != (hidden, gates) or gates != 3 * hidden \
            or bh.shape != (gates,) or t_len < 1:
        raise ValueError(f"{name}: shapes [B={batch}, T={t_len}, 3H={gates}], "
                         f"wh {tuple(wh.shape)}, bh {tuple(bh.shape)}")
    if hidden % _CHUNK_J:
        raise ValueError(f"{name}: hidden {hidden} is not a multiple of "
                         f"{_CHUNK_J}")
    w_gk = wh.t().contiguous()
    for arg, t in (("wh", w_gk), ("bh", bh)):
        _build.check_operand(name, arg, t, torch.bfloat16, device)
    return w_gk


def gru_last_state(xi: torch.Tensor, wh: torch.Tensor,
                   bh: torch.Tensor) -> torch.Tensor:
    """Last GRU state [B, H] f32 of xi [B, T, 3H] under recurrent weights
    wh [H, 3H] and bias bh [3H].

    CPU tensors run :func:`gru_last_state_reference`. CUDA tensors launch
    the kernel, which takes bf16 operands and H a multiple of 32 (up to the
    H whose bf16 state tile of 64 rows fits in shared memory: above it the
    launch raises); anything else raises. Pass ``weight_hh.t()`` as ``wh``
    and no copy is made.
    """
    if xi.device.type == "cpu":
        return gru_last_state_reference(xi, wh, bh)
    name = "gru_last_state"
    batch, t_len, gates = xi.shape
    w_gk = check_recurrent(name, batch, t_len, gates, wh, bh, xi.device)
    _build.check_operand(name, "xi", xi, torch.bfloat16, xi.device)
    hidden = wh.shape[0]
    out = torch.empty((batch, hidden), dtype=torch.float32, device=xi.device)
    _build.launch(name, "gru_last_state_forward", xi.device, xi, w_gk, bh,
                  out, batch, t_len, hidden)
    return out
