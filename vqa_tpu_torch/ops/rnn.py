"""Recurrent layers over fixed-length sequences, and the decoders' cells.

Counterpart of ``vqa_tpu/ops/rnn.py``. The input projection ``x @ W_i`` for
all time steps is one matmul up front; the loop carries only the recurrent
``h @ W_h``. The question encoder's output is the last *padded* step, as in
the reference (``output[:, -1]``). Gate order is torch's (GRU r, z, n; LSTM
i, f, g, o), and the parameters are named and shaped as ``nn.GRU``'s
(``rnn.weight_ih_l0`` [G*H, in], ...), so reference weights load as they are.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.kernels import gru_v2
from vqa_tpu_torch.ops.linear import uniform_


def gru_step(h: torch.Tensor, xi: torch.Tensor, hi: torch.Tensor
             ) -> torch.Tensor:
    """Combine the input projection xi and hidden projection hi [B, 3H]
    (gate order r, z, n) with the state h [B, H]."""
    hdim = h.shape[-1]
    xr, xz, xn = xi[..., :hdim], xi[..., hdim:2 * hdim], xi[..., 2 * hdim:]
    hr, hz, hn = hi[..., :hdim], hi[..., hdim:2 * hdim], hi[..., 2 * hdim:]
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def lstm_step(c: torch.Tensor, h: torch.Tensor, xi: torch.Tensor,
              hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch LSTM cell update from precomputed projections (i, f, g, o)."""
    hdim = h.shape[-1]
    gates = xi + hi
    i = torch.sigmoid(gates[..., :hdim])
    f = torch.sigmoid(gates[..., hdim:2 * hdim])
    g = torch.tanh(gates[..., 2 * hdim:3 * hdim])
    o = torch.sigmoid(gates[..., 3 * hdim:])
    c_new = f * c + i * g
    return c_new, o * torch.tanh(c_new)


def rnn_scan(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
             w_hh: torch.Tensor, b_hh: torch.Tensor, rnn_type: str = "GRU",
             reverse: bool = False) -> torch.Tensor:
    """One direction of one layer over x [B, T, in] -> [B, T, H], with
    torch-layout weights (w_ih [G*H, in], w_hh [G*H, H]), in x's dtype."""
    batch, t_len, _ = x.shape
    hdim = w_hh.shape[1]
    dt = x.dtype
    xi_all = torch.matmul(x, w_ih.to(dt).t()) + b_ih.to(dt)
    w_h, b_h = w_hh.to(dt).t(), b_hh.to(dt)
    h = x.new_zeros((batch, hdim))
    c = x.new_zeros((batch, hdim))
    ys = [None] * t_len
    for t in (reversed(range(t_len)) if reverse else range(t_len)):
        hi = torch.matmul(h, w_h) + b_h
        if rnn_type == "GRU":
            h = gru_step(h, xi_all[:, t], hi)
        else:
            c, h = lstm_step(c, h, xi_all[:, t], hi)
        ys[t] = h
    return torch.stack(ys, dim=1)


class RNNCell(nn.Module):
    """One GRU/LSTM step (counterpart of ``vqa_tpu/ops/rnn.py``
    ``RNNCellBase``), with ``nn.GRUCell``'s parameter names and layout:
    ``weight_ih`` [G*H, in], ``weight_hh`` [G*H, H], ``bias_ih``,
    ``bias_hh``, all U(-1/sqrt(H), 1/sqrt(H)). The carry is h [B, H] for a
    GRU and (h, c) for an LSTM; the step runs in the input's dtype."""

    def __init__(self, in_dim: int, hidden_dim: int, rnn_type: str = "GRU",
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_type not in ("GRU", "LSTM"):
            raise ValueError(f"unknown rnn_type: {rnn_type}")
        self.rnn_type = rnn_type
        bound = 1.0 / math.sqrt(hidden_dim)
        gh = (3 if rnn_type == "GRU" else 4) * hidden_dim
        for name, shape in (("weight_ih", (gh, in_dim)),
                            ("weight_hh", (gh, hidden_dim)),
                            ("bias_ih", (gh,)), ("bias_hh", (gh,))):
            self.register_parameter(name, nn.Parameter(
                uniform_(torch.empty(shape), bound, generator)))

    def forward(self, carry, x: torch.Tensor, *, rows=None,
                extra_xi: Optional[torch.Tensor] = None,
                gates_only: bool = False):
        """carry, x [B, in] -> the next carry.

        Row-span mode, which lets a decoder compute the input gates of an
        input slice that no step changes once per batch: ``rows`` is a
        (start, end) span, or a list of them, of the concatenated input
        that ``x`` holds (columns of ``weight_ih``); ``extra_xi`` is added to
        the input gates (the precomputed contribution of the other rows);
        ``gates_only`` returns ``x @ weight_ih[:, rows].T`` alone, without
        bias or step. The parameters stay the same.
        """
        w = self.weight_ih
        if rows is not None:
            spans = [rows] if isinstance(rows, tuple) else list(rows)
            w = torch.cat([w[:, a:b] for a, b in spans], dim=1)
        xi = torch.matmul(x, w.to(x.dtype).t())
        if gates_only:
            return xi
        if extra_xi is not None:
            xi = xi + extra_xi
        xi = xi + self.bias_ih.to(x.dtype)
        h = carry if self.rnn_type == "GRU" else carry[0]
        hi = torch.matmul(h, self.weight_hh.to(h.dtype).t()) \
            + self.bias_hh.to(h.dtype)
        if self.rnn_type == "GRU":
            return gru_step(h, xi, hi)
        c_new, h_new = lstm_step(carry[1], h, xi, hi)
        return h_new, c_new


class _RNNWeights(nn.Module):
    """Parameters named like ``nn.GRU``/``nn.LSTM``'s:
    ``{weight,bias}_{ih,hh}_l{k}[_reverse]``."""

    def __init__(self, in_dim: int, hidden_dim: int, rnn_layer: int,
                 ngates: int, ndir: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_dim)
        gh = ngates * hidden_dim
        for layer in range(rnn_layer):
            layer_in = in_dim if layer == 0 else hidden_dim * ndir
            for direction in range(ndir):
                sfx = f"l{layer}" + ("_reverse" if direction else "")
                for name, shape in (("weight_ih", (gh, layer_in)),
                                    ("weight_hh", (gh, hidden_dim)),
                                    ("bias_ih", (gh,)), ("bias_hh", (gh,))):
                    self.register_parameter(f"{name}_{sfx}", nn.Parameter(
                        uniform_(torch.empty(shape), bound, generator)))

    def layer(self, layer: int, direction: int):
        """(weight_ih, bias_ih, weight_hh, bias_hh) of one layer/direction."""
        sfx = f"l{layer}" + ("_reverse" if direction else "")
        return tuple(getattr(self, f"{n}_{sfx}") for n in
                     ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))


class SentenceEmbedding(nn.Module):
    """Batch-first multi-layer (bi)RNN returning the last *padded* step
    [B, H * ndir]; for bidirectional, concat(forward last step, backward
    step-0 output) (reference modules.py:98-163). ``forward_all`` returns
    every step's output.

    ``use_pallas`` routes inference to the gru_v2 kernel on the JAX
    package's eligibility (GRU, 1 layer, unidirectional, bf16, B % 8 == 0)
    where the kernel takes the width (``gru_v2.supports``: H a multiple of
    32). Every other configuration runs the plain scan.
    """

    def __init__(self, in_dim: int, hidden_dim: int, rnn_layer: int = 1,
                 dropout: float = 0.0, rnn_type: str = "GRU",
                 bidirect: bool = False, use_pallas: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_type not in ("GRU", "LSTM"):
            raise ValueError(f"unknown rnn_type: {rnn_type}")
        self.hidden_dim = hidden_dim
        self.rnn_layer = rnn_layer
        self.rnn_type = rnn_type
        self.bidirect = bidirect
        self.use_pallas = use_pallas
        self.drop = nn.Dropout(dropout)
        self.rnn = _RNNWeights(in_dim, hidden_dim, rnn_layer,
                               3 if rnn_type == "GRU" else 4,
                               2 if bidirect else 1, generator)

    def _kernel_eligible(self, x: torch.Tensor) -> bool:
        return (self.use_pallas and not self.training
                and self.rnn_type == "GRU" and self.rnn_layer == 1
                and not self.bidirect and x.dtype == torch.bfloat16
                and x.shape[0] % 8 == 0
                and gru_v2.supports(x.shape[1], self.hidden_dim, x.dtype))

    def forward_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, in] -> every step's output [B, T, H * ndir], always
        through the plain scan (the GRU kernel computes the last state
        only)."""
        ndir = 2 if self.bidirect else 1
        out = x
        for layer in range(self.rnn_layer):
            outs = [rnn_scan(out, *self.rnn.layer(layer, d), self.rnn_type,
                             reverse=bool(d)) for d in range(ndir)]
            out = torch.cat(outs, dim=-1)
            # torch applies inter-layer dropout on all but the last layer
            if layer < self.rnn_layer - 1:
                out = self.drop(out)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, in] -> [B, H * ndir]."""
        if self._kernel_eligible(x):
            w_ih, b_ih, w_hh, b_hh = self.rnn.layer(0, 0)
            # the input GEMM for all steps stays a plain matmul, as in JAX
            xi_all = torch.matmul(x, w_ih.to(x.dtype).t()) + b_ih.to(x.dtype)
            out = gru_v2.gru_last_state_v2(xi_all, w_hh.to(x.dtype).t(),
                                           b_hh.to(x.dtype))
            return out.to(x.dtype)
        out = self.forward_all(x)
        if not self.bidirect:
            return out[:, -1]
        return torch.cat([out[:, -1, :self.hidden_dim],
                          out[:, 0, self.hidden_dim:]], dim=1)
