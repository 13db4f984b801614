"""Last hidden state of a 1-layer GRU from precomputed input gates.

Counterpart of ``vqa_tpu/ops/pallas/gru_v2.py`` ``gru_last_state_v2``; the
CUDA kernel is ``vqa_tpu_torch/csrc/gru.cu``, the sequence kernel that also
serves ``gru_last_state`` (:mod:`.gru`, the same function) and
``gru_last_state_v3`` (:mod:`.gru_v3`). Gate order r, z, n (torch).
Rounding points follow the TPU kernel: ``xi`` and ``bh`` are upcast to f32,
the state ``h`` is carried in f32 but rounded to ``wh``'s dtype as the
matmul operand, products accumulate in f32, and the result is f32 (the
caller casts it back to the activation dtype).

The kernel runs the whole sequence in one launch. A thread block cluster of
c blocks owns 64 batch rows (one wgmma M); each block owns H / c hidden
units, streams their recurrent weight rows by TMA through an mbarrier ring
every step, keeps the whole 64-row bf16 state resident in shared memory as
wgmma's A operand, and after each step copies its units' new state into
every block of the cluster through distributed shared memory. :func:`_plan`
picks c from B so that the grid fills the card: at the question GRU's
B=512 there are only 8 row tiles. Where the resident state does not fit in
shared memory (H above 1024), it lives in device memory instead
(``gru_query`` tells). Measured by ``chip_smoke.py`` on an NVIDIA H100
80GB HBM3 at 700 W (T=10, H=1024): 0.288 ms at B=512 (clusters of 8),
3.234 ms at B=16384 (single blocks), against 0.31 and 5.7-5.9 ms for the
per-step design it replaced (PERF.md).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from vqa_tpu_torch.ops.kernels import _build

# copies of the kernel's constants: the hidden units of one warpgroup's
# chunk (H / c must be a multiple), the batch rows of a cluster's tile, and
# the cluster sizes it is built for
_CHUNK_J = 32
_TILE_B = 64
_CLUSTERS = (1, 2, 4, 8, 16)

# per (device index, H, v3): (state resident in shared memory, SMs, the
# clusters of each size the card holds at once)
_CAPS: Dict[Tuple[int, int, bool], Tuple[bool, int, Dict[int, int]]] = {}


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


def _plan(batch: int, hidden: int, sms: int, max_cluster: int) -> int:
    """The cluster size c for the sequence kernel on a card of ``sms`` SMs:
    the largest of 1, 2, 4, 8, 16 up to ``max_cluster`` whose grid, c blocks
    for each of the ceil(B / 64) row tiles, stays within one wave and that
    :func:`cluster_fits` H. A larger c gives each block fewer units to
    stream a step; past one wave, blocks would wait for a second."""
    tiles = -(-batch // _TILE_B)
    best = 1
    for c in _CLUSTERS:
        if c <= max_cluster and cluster_fits(hidden, c) and tiles * c <= sms:
            best = c
    return best


def cluster_fits(hidden: int, c: int) -> bool:
    """Whether c blocks can share a row tile of width H: each takes H / c
    units, chunks of 32, and whole 64-unit K tiles of the state when c > 1
    (the kernel's bulk copies move them between the blocks)."""
    return hidden % (_CHUNK_J * c) == 0 and (c == 1 or hidden % (2 * _CHUNK_J * c) == 0)


def _device_caps(device: torch.device, hidden: int,
                 v3: bool) -> Tuple[bool, int, Dict[int, int]]:
    """What the card tells of the sequence kernel at width ``hidden``
    (``gru_query``, built at first use): whether the state stays resident in
    shared memory, the SM count, and for each cluster size how many such
    clusters it schedules at once (``cudaOccupancyMaxActiveClusters``)."""
    key = (device.index or 0, hidden, v3)
    if key not in _CAPS:
        resident = ctypes.c_int(0)
        capacity = (ctypes.c_int * len(_CLUSTERS))()
        sms = ctypes.c_int(0)
        _build.query("gru_sequence", "gru_query", device, hidden, int(v3),
                     ctypes.addressof(resident), ctypes.addressof(capacity),
                     ctypes.addressof(sms))
        _CAPS[key] = (bool(resident.value), sms.value,
                      dict(zip(_CLUSTERS, capacity)))
    return _CAPS[key]


def launch_plan(device: torch.device, batch: int, hidden: int,
                v3: bool) -> Tuple[int, Optional[torch.Tensor]]:
    """(cluster size, the [2, B, H] bf16 device-memory state or None where
    the state stays resident) for one launch of the sequence kernel. The
    largest cluster considered is the largest whose clusters the card holds
    all at once for B's row tiles (a 16-block cluster needs 16 free SMs of
    one GPC, which not every GPC has)."""
    resident, sms, capacity = _device_caps(device, hidden, v3)
    tiles = -(-batch // _TILE_B)
    max_cluster = max(c for c in _CLUSTERS if c == 1 or capacity[c] >= tiles)
    cluster = _plan(batch, hidden, sms, max_cluster)
    h16 = None if resident else torch.empty((2, batch, hidden), dtype=torch.bfloat16,
                                            device=device)
    return cluster, h16


def check_recurrent(name: str, batch: int, t_len: int, gates: int,
                    wh: torch.Tensor, bh: torch.Tensor,
                    device: torch.device) -> torch.Tensor:
    """Validate the recurrent operands of the sequence kernel; returns the
    weight gate-major ([3H, H], torch's ``weight_hh`` layout: pass
    ``weight_hh.t()`` as ``wh`` and no copy is made)."""
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


def sequence(name: str, xi: torch.Tensor, wh: torch.Tensor,
             bh: torch.Tensor) -> torch.Tensor:
    """The sequence kernel on input gates xi, counted as kernel ``name``."""
    batch, t_len, gates = xi.shape
    w_gk = check_recurrent(name, batch, t_len, gates, wh, bh, xi.device)
    _build.check_operand(name, "xi", xi, torch.bfloat16, xi.device)
    hidden = wh.shape[0]
    out = torch.empty((batch, hidden), dtype=torch.float32, device=xi.device)
    cluster, h16 = launch_plan(xi.device, batch, hidden, v3=False)
    _build.launch(name, "gru_last_state_forward", xi.device, xi, w_gk, bh,
                  out, h16, batch, t_len, hidden, cluster)
    return out


def gru_last_state_v2(xi: torch.Tensor, wh: torch.Tensor,
                      bh: torch.Tensor) -> torch.Tensor:
    """Last GRU state [B, H] f32 of xi [B, T, 3H] under recurrent weights
    wh [H, 3H] and bias bh [3H].

    CPU tensors run :func:`gru_last_state_v2_reference`. CUDA tensors launch
    the kernel, which takes bf16 operands, any B >= 1 and H a multiple of 32;
    anything else raises. The kernel reads the weight gate-major ([3H, H],
    torch's ``weight_hh`` layout): pass ``weight_hh.t()`` and no copy is
    made.
    """
    if xi.device.type == "cpu":
        return gru_last_state_v2_reference(xi, wh, bh)
    return sequence("gru_v2", xi, wh, bh)
