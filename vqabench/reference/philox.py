"""Dropout masks of the caption scan, computed afresh from their contract.

The masks are Philox4x32-10 (Salmon et al., SC'11, the Random123
generator), one call a (step, row, box, 16-lane group): key (seed,
step + (stream << 16)), counter (row, box, group, 0). Byte j of output
word i gates lane 16 * group + 4 i + j, which is kept when the byte is
below ``thresh``; survivors are scaled by 256 / thresh, where thresh is
the keep probability in 256ths, rounded, within [1, 255]. Stream 0 is the
attention joint [rows, boxes, H], streams 1 and 2 the word-RNN and
language-RNN states [rows, H] (one box).
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
WEYL0, WEYL1 = 0x9E3779B9, 0xBB67AE85
U32 = 0xFFFFFFFF


def keep_law(p_drop: float):
    """(thresh, scale) of dropout ``p_drop``."""
    thresh = min(255, max(1, round((1.0 - p_drop) * 256)))
    return thresh, 256.0 / thresh


def _mul_hi_lo(m: int, x: torch.Tensor):
    """High and low 32-bit words of the 64-bit product ``m * x`` (x holds
    32-bit values in int64), with the constant split in 16-bit halves so
    that no partial product passes 2**48."""
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    low = a + ((b & 0xFFFF) << 16)
    return ((b >> 16) + (low >> 32)) & U32, low & U32


def philox(ctr, key):
    """Philox4x32 with 10 rounds; ``ctr`` four int64 tensors of 32-bit
    words and ``key`` two (ints or tensors), broadcast together."""
    x0, x1, x2, x3 = ctr
    k0, k1 = key
    for i in range(10):
        if i > 0:
            k0 = (k0 + WEYL0) & U32
            k1 = (k1 + WEYL1) & U32
        hi_a, lo_a = _mul_hi_lo(M0, x0)
        hi_b, lo_b = _mul_hi_lo(M1, x2)
        x0, x1, x2, x3 = hi_b ^ x1 ^ k0, lo_b, hi_a ^ x3 ^ k1, lo_a
    return x0, x1, x2, x3


def keep(seed: int, step: int, row0: int, rows: int, boxes: int, width: int,
         thresh: int, stream: int, device) -> torch.Tensor:
    """Bool keep mask [rows, boxes, width] of one step for batch rows
    ``row0 .. row0 + rows``."""
    groups = -(-width // 16)
    i64 = dict(dtype=torch.int64, device=device)
    r = torch.arange(row0, row0 + rows, **i64).view(-1, 1, 1)
    n = torch.arange(boxes, **i64).view(1, -1, 1)
    g = torch.arange(groups, **i64).view(1, 1, -1)
    zero = torch.zeros((), **i64)
    words = philox((r, n, g, zero),
                   (int(seed) & U32, (step + (stream << 16)) & U32))
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)  # [r, n, g, 4]
    shift = torch.tensor([0, 8, 16, 24], **i64)
    lanes = (words[..., None] >> shift) & 0xFF                   # [.., 4, 4]
    lanes = lanes.reshape(rows, boxes, groups * 16)[..., :width]
    return lanes < thresh
