"""Beam-decode throughput: the plain vocab head against the fused vocab
kernel (counterpart of ``scripts/bench_beam.py``).

The BUTD caption model at the flagship's widths beam-decodes B=4096 images
(k=3, c_len=20, bf16, dense features drawn on the device from a seed)
through ``make_beam_search``, with
``fused_vocab`` off (the [B*k, V] logits, ``topk_first`` and logsumexp) and
then on (``vocab_topk_lse``: GEMM, exact running top-k and online
logsumexp in one kernel). Each row is the best of ITERS decodes after
WARMUP, each ending in a host fetch of the best beams' first tokens, and
writes its kernel launches to stderr (``_bench_util.report_launches``).

    python -m vqa_tpu_torch.scripts.bench_beam [all|fused]

``all`` and ``fused`` run the same two rows. ``approx`` and ``streams``
exit 2: the approximate top-k has no exact counterpart in the port (its
top-k is exact), and the streams are a TPU interleave that gives the same
bits as one stream, so a row under either name would not measure what its
name says.
"""

from __future__ import annotations

import sys

import torch

from vqa_tpu_torch.models.wrapper import resolve_device, set_model
from vqa_tpu_torch.scripts._bench_util import (device_name, dtype_name, launch_counts,
                                               report_launches, timed)
from vqa_tpu_torch.tools.beam import make_beam_search

NOBJ, VDIM, QLEN = 36, 2048, 10
NTOKEN, EMBED, HIDDEN = 20000, 300, 1024
K, C_LEN = 3, 20
BATCH = 4096
WARMUP, ITERS = 2, 4
DEVICE = None   # the card; the tests set "cpu"

NOT_PORTED = {
    "approx": "the approximate vocab top-k (lax.approx_max_k) has no exact "
              "counterpart: the port's top-k is exact",
    "streams": "the software-pipelined streams are a TPU interleave that gives "
               "the same bits as one stream; a GPU stream has nothing to "
               "interleave",
}


def run(B: int, dtype: torch.dtype, fused: bool) -> float:
    """Print one row; return its best time in seconds."""
    dev = resolve_device(DEVICE)
    model = set_model(encoder_type="base", predictor_type="none",
                      decoder_type="butd", ntoken=NTOKEN, v_dim=VDIM,
                      embed_dim=EMBED, hidden_dim=HIDDEN,
                      decoder_hidden_dim=HIDDEN, att_type="new", c_len=C_LEN,
                      generator=torch.Generator().manual_seed(0), device=dev)
    model = model.to(dtype).eval()
    # drawn on the device from a seed: the values do not change the work
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {
        "img": torch.randn((B, NOBJ, VDIM), generator=gen, device=dev).to(dtype),
        "q": torch.randint(0, NTOKEN, (B, QLEN), generator=gen, device=dev),
        "c": torch.randint(0, NTOKEN, (B, C_LEN), generator=gen, device=dev),
        "cap_len": torch.full((B,), C_LEN, dtype=torch.int32, device=dev),
    }
    bs = make_beam_search(model, k=K, c_len=C_LEN, start_id=NTOKEN - 3,
                          end_id=NTOKEN - 2, fused_vocab=fused)

    def call():
        tokens, _ = bs(batch)
        return tokens[:, 0, 0]

    before = launch_counts()
    best = timed(call, warmup=WARMUP, iters=ITERS)
    name = f"B={B} {dtype_name(dtype)} {'fused-vocab' if fused else 'plain-vocab'} S=1"
    print(f"{name:44s} {best * 1e3:8.1f} ms   ({B / best:,.0f} captions/s)",
          flush=True)
    report_launches(name, before)
    return best


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which in NOT_PORTED:
        print(f"bench_beam {which}: not ported: {NOT_PORTED[which]}",
              file=sys.stderr)
        return 2
    if which not in ("all", "fused"):
        print(f"bench_beam: unknown mode {which!r} (all, fused)", file=sys.stderr)
        return 2
    dev = resolve_device(DEVICE)
    print("device:", device_name(dev), flush=True)
    if which == "all":
        for mode, reason in NOT_PORTED.items():
            print(f"bench_beam: the {mode} rows are not ported: {reason}",
                  file=sys.stderr)
    with torch.inference_mode():
        for fused in (False, True):
            run(BATCH, torch.bfloat16, fused)
    return 0


if __name__ == "__main__":
    sys.exit(main())
