"""End-to-end ReGAT (relation encoder + classifier) inference throughput
(counterpart of ``scripts/bench_regat.py``).

The full model forward (question GRU, attention, one spatial corr-GCN
layer, classifier) on dense features with spatial graphs (drawn on the
device from a seed), timed two ways
(``_bench_util``):

- per call: the best of 3 calls, each ending in a host fetch of the
  answer ids;
- chained (the default, as ``vqa_tpu_torch.bench`` times): REPS forwards
  chained through their answer ids (each perturbs the next one's question
  tokens) with no host sync between them, by CUDA events.

Each row also writes its kernel launches to stderr
(``_bench_util.report_launches``).

    python -m vqa_tpu_torch.scripts.bench_regat [full]

With no argument it runs B=8192 bf16 without and with ``use_int8`` (the
int8 GEMMs of the v-projection and the GCN's projections); ``full`` first
runs the JAX script's published rows (B=4096 f32 and bf16 per call,
B=16384 bf16 per call and chained).
"""

from __future__ import annotations

import sys

import torch

from vqa_tpu_torch.models.wrapper import resolve_device, set_model
from vqa_tpu_torch.scripts._bench_util import (chained_ms, device_name, dtype_name,
                                               launch_counts, report_launches, timed)

NOBJ, VDIM, QLEN = 36, 2048, 10
NTOKEN, ANS, EMBED, HIDDEN = 20000, 3129, 300, 1024
REPS = 8
# the default rows' batch, and the ``full`` rows' two
BATCH, FULL_BATCHES = 8192, (4096, 16384)
DEVICE = None   # the card; the tests set "cpu"


def run(B: int, dtype: torch.dtype, use_pallas: bool = False,
        use_int8: bool = False, conv_layer: int = 1,
        chained: bool = True) -> float:
    """Print one row; return its ms a forward."""
    dev = resolve_device(DEVICE)
    model = set_model(encoder_type="relation", predictor_type="base",
                      decoder_type="none", ntoken=NTOKEN, v_dim=VDIM,
                      embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=ANS,
                      att_type="new", conv_type="corr",
                      conv_layer=conv_layer, use_pallas=use_pallas,
                      use_int8=use_int8,
                      generator=torch.Generator().manual_seed(0), device=dev)
    model = model.to(dtype).eval()
    # drawn on the device from a seed: the values do not change the work
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {
        "img": torch.randn((B, NOBJ, VDIM), generator=gen, device=dev).to(dtype),
        "q": torch.randint(0, NTOKEN, (B, QLEN), generator=gen, device=dev),
        "graph": torch.randint(0, 12, (B, NOBJ, NOBJ), generator=gen, device=dev,
                               dtype=torch.int32),
    }

    before = launch_counts()
    if chained:
        def step(c, batch):
            predict, _ = model(dict(batch, q=(batch["q"] + c[:, None]) % NTOKEN))
            return torch.argmax(predict, dim=-1)
        ms = chained_ms(step, torch.zeros(B, dtype=torch.long, device=dev),
                        (batch,), reps=REPS)
    else:
        def infer(batch):
            predict, _ = model(batch)
            return torch.argmax(predict, dim=-1)
        ms = timed(infer, batch) * 1e3

    name = (f"B={B} {dtype_name(dtype)}"
            f"{' +int8' if use_int8 else ''}"
            f"{' +fused' if use_pallas else ''}"
            f"{' chained' if chained else ' per-call'}")
    print(f"{name:44s} {ms:8.1f} ms   ({B / (ms / 1e3):,.0f} q/s)",
          flush=True)
    report_launches(name, before)
    return ms


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(DEVICE)
    print("device:", device_name(dev), flush=True)
    full = bool(argv) and argv[0] == "full"
    with torch.inference_mode():
        if full:  # the JAX script's published rows
            small, large = FULL_BATCHES
            run(small, torch.float32, chained=False)
            run(small, torch.bfloat16, chained=False)
            run(large, torch.bfloat16, chained=False)
            run(large, torch.bfloat16)
        run(BATCH, torch.bfloat16)
        run(BATCH, torch.bfloat16, use_int8=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
