"""Last hidden state of a 1-layer GRU from precomputed input gates.

Counterpart of ``vqa_tpu/ops/pallas/gru_v2.py`` ``gru_last_state_v2``; the
CUDA kernel is ``vqa_tpu_torch/csrc/gru_v2.cu``. Gate order r, z, n (torch).
Rounding points follow the TPU kernel: ``xi`` and ``bh`` are upcast to f32,
the state ``h`` is carried in f32 but rounded to ``wh``'s dtype as the
matmul operand, products accumulate in f32, and the result is f32 (the
caller casts it back to the activation dtype).
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.kernels import _build

# hidden units per block; the kernel also tiles the reduction over H by it
_TILE_J = 32


def gru_last_state_v2_reference(xi: torch.Tensor, wh: torch.Tensor,
                                bh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. xi [B, T, 3H], wh [H, 3H], bh [3H] -> [B, H] f32."""
    batch, t_len, _ = xi.shape
    hidden = wh.shape[0]
    w = wh.float()
    b = bh.float()
    h = xi.new_zeros((batch, hidden), dtype=torch.float32)
    for t in range(t_len):
        x = xi[:, t].float()
        # bf16 operand, f32 products and sum: exact bf16 products in f32
        hi = torch.matmul(h.to(wh.dtype).float(), w) + b
        r = torch.sigmoid(x[:, :hidden] + hi[:, :hidden])
        z = torch.sigmoid(x[:, hidden:2 * hidden] + hi[:, hidden:2 * hidden])
        n = torch.tanh(x[:, 2 * hidden:] + r * hi[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
    return h


def gru_last_state_v2(xi: torch.Tensor, wh: torch.Tensor,
                      bh: torch.Tensor) -> torch.Tensor:
    """Last GRU state [B, H] f32 of xi [B, T, 3H] under recurrent weights
    wh [H, 3H] and bias bh [3H].

    CPU tensors run :func:`gru_last_state_v2_reference`. CUDA tensors launch
    the kernel, which takes bf16 operands and H a multiple of 32; anything
    else raises. The kernel reads the weight gate-major ([3H, H], torch's
    ``weight_hh`` layout): pass ``weight_hh.t()`` and no copy is made.
    """
    if xi.device.type == "cpu":
        return gru_last_state_v2_reference(xi, wh, bh)
    batch, t_len, gates = xi.shape
    hidden = wh.shape[0]
    if wh.shape != (hidden, gates) or gates != 3 * hidden \
            or bh.shape != (gates,) or t_len < 1:
        raise ValueError(f"gru_v2: shapes xi {tuple(xi.shape)}, wh "
                         f"{tuple(wh.shape)}, bh {tuple(bh.shape)}")
    if hidden % _TILE_J:
        raise ValueError(f"gru_v2: hidden {hidden} is not a multiple of "
                         f"{_TILE_J}")
    w_gk = wh.t().contiguous()
    for name, t in (("xi", xi), ("wh", w_gk), ("bh", bh)):
        _build.check_operand("gru_v2", name, t, torch.bfloat16, xi.device)
    # the state ping-pongs between two halves, one launch per time step, in
    # f32 and as its bf16 rounding (the next step's matmul operand)
    h32 = torch.empty((2, batch, hidden), dtype=torch.float32, device=xi.device)
    h16 = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=xi.device)
    _build.launch("gru_v2", "gru_v2_forward", xi.device, xi, w_gk, bh,
                  h32, h16, batch, t_len, hidden)
    return h32[t_len % 2]
