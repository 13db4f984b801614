"""Training-step throughput, REPS chained steps a measurement
(counterpart of ``scripts/bench_train.py``).

A training loop runs its steps back to back with no host sync, as
``training/train.py`` does between logging points: each measurement runs
REPS steps of ``make_train_step`` (loss, backward, clip and grouped Adamax
update; bf16 compute over f32 masters where the row says so), then fetches
their losses, and each row is the best of ITERS measurements after WARMUP,
in ms a step; each row writes its kernel launches to stderr
(``_bench_util.report_launches``).

    python -m vqa_tpu_torch.scripts.bench_train [MODE]

Modes (the JAX script's): ``vqa``, ``vqa-int8``, ``vqa-int8-xl``,
``mtl``, ``mtl-scale``, ``vjp``, ``int8``, ``ab``, ``regat``, ``pa``;
``all`` (the default) runs vqa, mtl, mtl-scale, vjp and int8. The
JAX rows that only switch a lowering of its scan have no counterpart, and
each mode names the ones it leaves out on stderr (:data:`NOT_PORTED`):
the port's caption scan is always its hand-written backward, its dropout
masks always follow the 8-bit keep law. ``pallas att`` rows run the
decode-attention kernels (``use_pallas``; in training the encoder's
inference kernels run their plain versions, as in the JAX package).
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from vqa_tpu_torch.bench import quantize
from vqa_tpu_torch.models.wrapper import resolve_device, set_model
from vqa_tpu_torch.scripts._bench_util import (device_name, launch_counts, report_launches,
                                               timed)
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import TrainState, make_train_step

NOBJ, VDIM, QLEN, CLEN = 36, 2048, 10, 20
NTOKEN, ANS, EMBED, HIDDEN = 20000, 3129, 300, 1024
WARMUP, ITERS, REPS = 1, 3, 8
DEVICE = None   # the card; the tests set "cpu"
BF16 = torch.bfloat16

# the JAX rows with no counterpart in the port, by mode, with the reason
NOT_PORTED = {
    "vjp": ["MTL B=4096 c=20, nn.scan+remat (stock): the port has one caption "
            "scan, its hand-written backward; nn.scan with remat is a JAX "
            "lowering of the same step"],
    "ab": ["MTL B=4096 c=12, dense, bernoulli masks: the port's dropout masks "
           "follow the 8-bit keep law only (quantized_keep); Bernoulli masks "
           "were the JAX scan's earlier layout"],
}


def run(name: str, caption: bool = False,
        compute_dtype: Optional[torch.dtype] = None, B: int = 512,
        fused_cap: bool = True, clen: int = CLEN, feed: str = "dense",
        pallas_att: bool = False, encoder: str = "base"):
    """Print one row; return (ms a step, the last measurement's losses)."""
    dev = resolve_device(DEVICE)
    model = set_model(encoder_type=encoder, predictor_type="base",
                      decoder_type="butd" if caption else "none",
                      ntoken=NTOKEN, v_dim=VDIM, embed_dim=EMBED,
                      hidden_dim=HIDDEN, decoder_hidden_dim=HIDDEN,
                      ans_dim=ANS, c_len=CLEN, att_type="new",
                      use_mtl=caption, conv_type="corr", conv_layer=1,
                      use_pallas=pallas_att,
                      generator=torch.Generator().manual_seed(0), device=dev)
    # the r2 layout: the caption loss through the teacher-forced forward
    model.fused_cap_loss = fused_cap
    # drawn on the device from a seed: the values do not change the work
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.randn((B, NOBJ, VDIM), generator=gen, device=dev)
    batch = {
        "q": torch.randint(0, NTOKEN, (B, QLEN), generator=gen, device=dev),
        "a": (torch.rand((B, ANS), generator=gen, device=dev) < 0.01).float(),
    }
    if encoder == "relation":
        # spatial relation labels: 0 = no edge, 1..11 = edge classes
        batch["graph"] = torch.randint(0, 12, (B, NOBJ, NOBJ), generator=gen,
                                       device=dev, dtype=torch.int32)
    if feed == "int8":
        # the production quantized feed (``quantize_features`` on the
        # device): the decode scan pools over the int8 payload and the
        # gradient of v is a [B, objs] accumulate
        batch["img_q"], batch["img_scale"] = quantize(img)
    else:
        batch["img"] = img
    del img
    if caption:
        # clen < CLEN emulates a length-bucketed batch
        batch["c"] = torch.randint(0, NTOKEN, (B, clen), generator=gen, device=dev)
        batch["cap_len"] = torch.randint(5, clen + 1, (B,), generator=gen, device=dev,
                                         dtype=torch.int32)

    opt = make_optimizer(model, lr=2e-3, max_norm=0.25, warm_up=1,
                         step_size=2, gamma=0.5, steps_per_epoch=1000)
    state = TrainState(model, opt, seed=0)
    step = make_train_step(model, opt, compute_dtype=compute_dtype)

    last = []

    def steps():
        last[:] = [torch.stack([step(state, batch)["loss"] for _ in range(REPS)])]
        return last[0]

    before = launch_counts()
    best = timed(steps, warmup=WARMUP, iters=ITERS)
    ms = best * 1e3 / REPS
    print(f"{name:44s} {ms:8.1f} ms/step   ({B / (ms / 1e3):,.0f} q/s)",
          flush=True)
    report_launches(name, before)
    return ms, last[0].cpu()


def _vqa():
    run("Up-Down VQA, B=512, bf16 mixed (train default)", compute_dtype=BF16)
    run("Up-Down VQA, B=4096, bf16 mixed", compute_dtype=BF16, B=4096)


def _vqa_int8():
    # the forward's dequant fuses into the v-projection and lazy-v pools over
    # the int8 payload; features are data, so no gradient of v exists
    run("Up-Down VQA, B=4096, bf16 mixed (dense window)", compute_dtype=BF16, B=4096)
    run("Up-Down VQA, B=4096, bf16 mixed, int8 feed", compute_dtype=BF16, B=4096,
        feed="int8")
    run("Up-Down VQA, B=8192, bf16 mixed, int8 feed", compute_dtype=BF16, B=8192,
        feed="int8")


def _vqa_int8_xl():
    run("Up-Down VQA, B=8192, bf16 mixed (dense)", compute_dtype=BF16, B=8192)
    run("Up-Down VQA, B=16384, bf16 mixed, int8 feed", compute_dtype=BF16,
        B=16384, feed="int8")


def _mtl():
    run("MTL VQA+BUTD, B=512, bf16, stacked (r2 layout)", caption=True,
        compute_dtype=BF16, fused_cap=False)
    run("MTL VQA+BUTD, B=512, bf16, fused cap loss", caption=True, compute_dtype=BF16)
    run("MTL VQA+BUTD, B=2048, bf16, fused cap loss", caption=True,
        compute_dtype=BF16, B=2048)
    run("MTL VQA+BUTD, B=4096, bf16, fused cap loss", caption=True,
        compute_dtype=BF16, B=4096)
    run("MTL VQA+BUTD, B=4096, bf16, fused, c=12 bucket", caption=True,
        compute_dtype=BF16, B=4096, clen=12)


def _mtl_scale():
    run("MTL VQA+BUTD, B=6144, bf16, fused, c=12 bucket", caption=True,
        compute_dtype=BF16, B=6144, clen=12)
    run("MTL VQA+BUTD, B=4096, bf16, fused, c=9 bucket", caption=True,
        compute_dtype=BF16, B=4096, clen=9)


def _vjp():
    run("MTL B=4096 c=20, custom-VJP scan", caption=True, compute_dtype=BF16, B=4096)
    run("MTL B=4096 c=12 bucket, custom-VJP scan", caption=True,
        compute_dtype=BF16, B=4096, clen=12)
    run("MTL B=4096 c=9 bucket, custom-VJP scan", caption=True,
        compute_dtype=BF16, B=4096, clen=9)


def _int8():
    # the int8 feed: the scan pools over the payload, grad-of-v a [B, objs]
    # accumulate
    run("MTL B=4096 c=20, int8 feed (factored scan)", caption=True,
        compute_dtype=BF16, B=4096, feed="int8")
    run("MTL B=4096 c=12 bucket, int8 feed", caption=True, compute_dtype=BF16,
        B=4096, clen=12, feed="int8")
    run("MTL B=4096 c=9 bucket, int8 feed", caption=True, compute_dtype=BF16,
        B=4096, clen=9, feed="int8")


def _ab():
    run("MTL B=4096 c=12, dense, uint8 masks", caption=True, compute_dtype=BF16,
        B=4096, clen=12)
    run("MTL B=4096 c=12, int8 feed (factored scan)", caption=True,
        compute_dtype=BF16, B=4096, clen=12, feed="int8")
    run("MTL B=4096 c=9, int8 feed", caption=True, compute_dtype=BF16, B=4096,
        clen=9, feed="int8")
    run("MTL B=4096 c=20, int8 feed", caption=True, compute_dtype=BF16, B=4096,
        feed="int8")
    run("MTL B=8192 c=12, int8 feed", caption=True, compute_dtype=BF16, B=8192,
        clen=12, feed="int8")


def _regat():
    run("ReGAT corr-conv train, B=512, bf16 mixed", encoder="relation",
        compute_dtype=BF16)
    run("ReGAT corr-conv train, B=2048, bf16 mixed", encoder="relation",
        compute_dtype=BF16, B=2048)
    run("ReGAT corr-conv train, B=4096, bf16 mixed", encoder="relation",
        compute_dtype=BF16, B=4096)


def _pa():
    # the decode-attention kernels: masks drawn in the kernels, no mask
    # residual
    run("MTL B=4096 c=12, int8 feed, pallas att", caption=True, compute_dtype=BF16,
        B=4096, clen=12, feed="int8", pallas_att=True)
    run("MTL B=4096 c=9, int8 feed, pallas att", caption=True, compute_dtype=BF16,
        B=4096, clen=9, feed="int8", pallas_att=True)
    run("MTL B=4096 c=20, int8 feed, pallas att", caption=True, compute_dtype=BF16,
        B=4096, feed="int8", pallas_att=True)
    run("MTL B=4096 c=12, int8 feed (plain reference window)", caption=True,
        compute_dtype=BF16, B=4096, clen=12, feed="int8")
    run("MTL B=8192 c=12, int8 feed, pallas att", caption=True, compute_dtype=BF16,
        B=8192, clen=12, feed="int8", pallas_att=True)
    run("MTL B=4096 c=12, dense, pallas att", caption=True, compute_dtype=BF16,
        B=4096, clen=12, pallas_att=True)


MODES = {"vqa": _vqa, "vqa-int8": _vqa_int8, "vqa-int8-xl": _vqa_int8_xl,
         "mtl": _mtl, "mtl-scale": _mtl_scale, "vjp": _vjp, "int8": _int8,
         "ab": _ab, "regat": _regat, "pa": _pa}
ALL = ("vqa", "mtl", "mtl-scale", "vjp", "int8")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which != "all" and which not in MODES:
        print(f"bench_train: unknown mode {which!r} ({', '.join(['all', *MODES])})",
              file=sys.stderr)
        return 2
    dev = resolve_device(DEVICE)
    print("device:", device_name(dev), flush=True)
    for mode in ALL if which == "all" else (which,):
        for row in NOT_PORTED.get(mode, ()):
            print(f"bench_train {mode}: not ported: {row}", file=sys.stderr)
        MODES[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
