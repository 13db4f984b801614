#!/usr/bin/env python3
"""Time kernels of one tree of the port at the batches the model paths
launch them at, and at their timed batches, on one card.

    python3 vqa_tpu_torch/tools/time_kernels.py [--root DIR] [--only NAME ...]

``--root`` names the checkout whose ``vqa_tpu_torch`` is imported (default:
the one that holds this script), so that two trees, for example the parent
commit unpacked by ``git archive`` beside the working tree, are timed by the
same code in one run on one card; each builds its own kernels. Only the
wrappers' public signatures are used. Prints the card's name and power
limit, then one JSON line per timing: ``gru_v2`` and ``gru_last_state`` (v1)
on the same xi at B = 512, 4096, 8192 and 16384 (T=10, H=1024, bf16), and
``decode_att_fwd`` at B = 512 and 4096 (36 boxes, H=1024, D=2048, bf16 over
the int8 payload, dropout 0.2), ``gcn_chain_fused`` at B = 512 and 8192
(36 boxes, D=2048, 12 spatial labels, bf16) and ``decode_att_dvp`` at B =
512 and 4096 (T=19, 36 boxes, H=1024, bf16, dropout 0.2, and again
without dropout, which leaves out the Philox draws) and
``fused_multiply_attention_pool`` at B = 16384 (36 boxes, Dv=2048,
H=Hq=1024, bf16, f32 vectors) and ``dequant_matmul`` at the B=16384
forward's v-projection (M = 16384 x 36, K=2048, N=1024), each by CUDA
events over ``--iters`` calls after a warm-up, in the order kernel, kernel
(two means, both printed). ``--only`` times the named kernels alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

GRU_BATCHES = (512, 4096, 8192, 16384)
ATT_BATCHES = (512, 4096)
CHAIN_BATCHES = (512, 8192)
DVP_BATCHES, DVP_STEPS = (512, 4096), 19
FORWARD_BATCHES = (16384,)   # the B=16384 forward's batch
KERNELS = ("gru_v2", "gru_last_state", "decode_att_fwd", "gcn_chain_fused",
           "decode_att_dvp", "fused_multiply_attention_pool", "dequant_matmul")
T_LEN, HIDDEN, OBJS, V_DIM, LABELS = 10, 1024, 36, 2048, 12
ATT_THRESH, ATT_SEED, ATT_STEP = 205, 0x5EED1234, 7


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here)
    parser.add_argument("--label", default="")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from vqa_tpu_torch.ops.kernels import (
        decode_att, feed_gemm, fused_attention, gcn_chain, gru, gru_v2)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def emit(**kw):
        print(json.dumps({"tree": args.label or args.root, "card": card, **kw}), flush=True)

    with torch.inference_mode():
        bound = HIDDEN ** -0.5
        wh = ((torch.rand(HIDDEN, 3 * HIDDEN, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        bh = ((torch.rand(3 * HIDDEN, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        for batch in GRU_BATCHES:
            if not {"gru_v2", "gru_last_state"} & set(args.only):
                break
            xi = torch.randn(batch, T_LEN, 3 * HIDDEN, device=dev, generator=gen).to(bf16)
            for name, fn in (("gru_v2", gru_v2.gru_last_state_v2),
                             ("gru_last_state", gru.gru_last_state)):
                if name in args.only:
                    ms = [time_ms(lambda: fn(xi, wh, bh), args.iters) for _ in range(2)]
                    emit(kernel=name, B=batch, T=T_LEN, H=HIDDEN, ms=ms)
            del xi
        k = ((torch.rand(HIDDEN, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        akw = dict(objs=OBJS, att_scale=256.0 / ATT_THRESH, thresh=ATT_THRESH)
        for batch in ATT_BATCHES if "decode_att_fwd" in args.only else ():
            vp = torch.rand(batch, OBJS * HIDDEN, device=dev, generator=gen).to(bf16)
            qp = torch.rand(batch, HIDDEN, device=dev, generator=gen).to(bf16)
            pool = torch.randint(-127, 128, (batch, OBJS * V_DIM), device=dev,
                                 generator=gen, dtype=torch.int8)
            w = torch.rand(batch, OBJS, device=dev, generator=gen).to(bf16)
            ms = [time_ms(lambda: decode_att.decode_att_fwd(
                vp, pool, w, qp, k, ATT_SEED, ATT_STEP, **akw), args.iters) for _ in range(2)]
            emit(kernel="decode_att_fwd", B=batch, H=HIDDEN, D=V_DIM, objs=OBJS,
                 regime="bf16-int8 dropout", ms=ms)
            del vp, qp, pool, w
        for batch in DVP_BATCHES if "decode_att_dvp" in args.only else ():
            dls = (torch.randn(DVP_STEPS, batch, OBJS, device=dev, generator=gen)
                   * 0.01).to(bf16)
            qps = torch.rand(DVP_STEPS, batch, HIDDEN, device=dev, generator=gen).to(bf16)
            for regime, thresh in (("bf16 dropout", ATT_THRESH), ("bf16 no dropout", None)):
                dkw = dict(akw, thresh=thresh, out_dtype=bf16)
                ms = [time_ms(lambda: decode_att.decode_att_dvp(dls, qps, k, ATT_SEED, **dkw),
                              args.iters) for _ in range(2)]
                emit(kernel="decode_att_dvp", B=batch, T=DVP_STEPS, H=HIDDEN, objs=OBJS,
                     regime=regime, ms=ms)
            del dls, qps
        for batch in CHAIN_BATCHES if "gcn_chain_fused" in args.only else ():
            chain = (torch.randn(batch, OBJS, V_DIM, device=dev, generator=gen).to(bf16),
                     torch.randn(batch, OBJS, V_DIM, device=dev, generator=gen).to(bf16),
                     torch.relu(torch.randn(batch, OBJS, OBJS, device=dev,
                                            generator=gen)).to(bf16),
                     torch.randint(0, LABELS, (batch, OBJS, OBJS), device=dev,
                                   generator=gen, dtype=torch.int32),
                     ((torch.rand(LABELS, V_DIM, device=dev, generator=gen) * 2 - 1)
                      * V_DIM ** -0.5).to(bf16))
            ms = [time_ms(lambda: gcn_chain.gcn_chain_fused(*chain), args.iters)
                  for _ in range(2)]
            emit(kernel="gcn_chain_fused", B=batch, N=OBJS, D=V_DIM, labels=LABELS,
                 regime="bf16", ms=ms)
            del chain
        name = "fused_multiply_attention_pool"
        for batch in FORWARD_BATCHES if name in args.only else ():
            def lin(n_in, *shape):   # a Linear's init for n_in inputs
                return ((torch.rand(*shape, device=dev, generator=gen) * 2 - 1)
                        * n_in ** -0.5)
            # the weights as the wrapper takes them, weight.t() ([in, out])
            pool = (torch.randn(batch, OBJS, V_DIM, device=dev, generator=gen).to(bf16),
                    (torch.rand(batch, HIDDEN, device=dev, generator=gen) * 2 - 1).to(bf16),
                    lin(V_DIM, HIDDEN, V_DIM).to(bf16).t(), lin(V_DIM, HIDDEN),
                    lin(HIDDEN, HIDDEN, HIDDEN).to(bf16).t(), lin(HIDDEN, HIDDEN),
                    lin(HIDDEN, 1, HIDDEN).t(), lin(HIDDEN, 1))
            ms = [time_ms(lambda: fused_attention.fused_multiply_attention_pool(*pool),
                          args.iters) for _ in range(2)]
            emit(kernel=name, B=batch, N=OBJS, Dv=V_DIM, H=HIDDEN, Hq=HIDDEN,
                 regime="bf16", ms=ms)
            del pool
        for batch in FORWARD_BATCHES if "dequant_matmul" in args.only else ():
            rows = batch * OBJS
            x_q = torch.randint(-127, 128, (rows, V_DIM), device=dev, generator=gen,
                                dtype=torch.int8)
            scale = (torch.rand(rows, device=dev, generator=gen) * 0.02 + 0.02).to(bf16)
            w = (((torch.rand(HIDDEN, V_DIM, device=dev, generator=gen) * 2 - 1)
                  * V_DIM ** -0.5).to(bf16).t())
            ms = [time_ms(lambda: feed_gemm.dequant_matmul(x_q, scale, w), args.iters)
                  for _ in range(2)]
            emit(kernel="dequant_matmul", M=rows, K=V_DIM, N=HIDDEN, regime="int8 feed, bf16",
                 ms=ms)
            del x_q, scale, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
