#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vqa_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. device: a CUDA card must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from ``vqa_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (ragged ones included), within a stated tolerance;
4. serve: the full-width Up-Down model (bf16, ``use_pallas=True``, weights
   from a seeded generator) answers a few batches of the int8 feed made by
   the repo's data layer, through ``VQAModel.forward_vqa``; every kernel's
   launch count must rise, and the logits must agree with the same model
   whose kernels are swapped for their plain versions;
5. timing (for information): each kernel and its plain version, and the
   forward with the kernels and with the plain path, at B=16384, by CUDA
   events.

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from unittest import mock

import torch

# the flagship Up-Down dims (__graft_entry__.py entry(), bench.py)
NTOKEN, EMBED, HIDDEN, V_DIM, OBJS, ANS, Q_LEN = 20000, 300, 1024, 2048, 36, 3129, 10
SERVE_BATCH, SERVE_REQUESTS = 512, 4
TIME_BATCH = 16384

# Tolerances. gru_v2: the f32 state |h| < 1; kernel and plain version sum in
# different orders, and where that flips the bf16 rounding of an h operand,
# the product moves by one bf16 ulp of one term, so errors stay far below
# 2e-3. dequant_matmul and pool_int8: bf16 outputs of f32 sums; a different
# sum order may round to the neighbouring bf16 value, one ulp, at most 2**-7
# of the value. Logits: the model with kernels against the same model with
# plain versions; the GRU's f32 differences can flip bf16 roundings of the
# question vector, which move the logits by a few bf16 ulps of the largest.
GRU_ATOL = 2e-3
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
LOGIT_REL_TOL = 3e-2

KERNELS = {
    "gru_v2": {"source": "vqa_tpu_torch/csrc/gru_v2.cu",
               "replaces": "vqa_tpu/ops/pallas/gru_v2.py:74"},
    "dequant_matmul": {"source": "vqa_tpu_torch/csrc/feed_gemm.cu",
                       "replaces": "vqa_tpu/ops/pallas/feed_gemm.py:55"},
    "pool_int8": {"source": "vqa_tpu_torch/csrc/lazyv_pool.cu",
                  "replaces": "vqa_tpu/ops/pallas/lazyv_pool.py:46"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(kernel_fn, plain_fn, iters: int):
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p0 = time_ms(plain_fn, iters)
    k0 = time_ms(kernel_fn, iters)
    k1 = time_ms(kernel_fn, iters)
    p1 = time_ms(plain_fn, iters)
    return (k0 + k1) / 2, (p0 + p1) / 2


def plain_kernels(stack: ExitStack, gru_v2, feed_gemm, lazyv_pool) -> None:
    """Swap each kernel wrapper for its plain version while ``stack`` is open."""
    stack.enter_context(mock.patch.object(
        gru_v2, "gru_last_state_v2", gru_v2.gru_last_state_v2_reference))
    stack.enter_context(mock.patch.object(
        feed_gemm, "dequant_matmul", feed_gemm.dequant_matmul_reference))
    stack.enter_context(mock.patch.object(
        lazyv_pool, "pool_int8", lazyv_pool.pool_int8_reference))


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vqa_tpu_torch.ops.kernels import _build, feed_gemm, gru_v2, lazyv_pool
    from vqa_tpu_torch.models.wrapper import set_model
    from vqa_tpu.data.dataset import set_dataset
    from vqa_tpu.data.loader import Loader
    from vqa_tpu.data.synthetic import make_synthetic_root

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # -- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.name} in {time.monotonic() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    max_err = {}

    def int8_feed(rows: int, k: int):
        x_q = torch.randint(-127, 128, (rows, k), device=dev, generator=gen,
                            dtype=torch.int8)
        # per-box absmax/127 of unit-normal features lands in [2.5, 4.5]/127
        scale = ((torch.rand(rows, device=dev, generator=gen) * 2 + 2.5) / 127).to(bf16)
        return x_q, scale

    def gru_inputs(batch: int):
        xi = torch.randn(batch, Q_LEN, 3 * HIDDEN, device=dev, generator=gen).to(bf16)
        bound = HIDDEN ** -0.5
        wh = ((torch.rand(HIDDEN, 3 * HIDDEN, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        bh = ((torch.rand(3 * HIDDEN, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        return xi, wh, bh

    def gemm_inputs(rows: int):
        x_q, scale = int8_feed(rows, V_DIM)
        w = ((torch.rand(V_DIM, HIDDEN, device=dev, generator=gen) * 2 - 1) * V_DIM ** -0.5).to(bf16)
        return x_q, scale, w

    def pool_inputs(batch: int):
        x_q, scale = int8_feed(batch * OBJS, V_DIM)
        att = torch.softmax(torch.randn(batch, OBJS, device=dev, generator=gen), dim=1)
        return (att * scale.view(batch, OBJS).float()).to(bf16), x_q.view(batch, OBJS, V_DIM)

    def compare(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float, shape: str) -> None:
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        bad = (diff > atol + rtol * want.float().abs()).sum().item()
        log(f"kernel {name} {shape}: max abs err {err:.3g} (max |plain| "
            f"{want.float().abs().max().item():.3g}), tolerance {atol:g} + "
            f"{rtol:g}*|plain|, {bad} elements outside")
        require(torch.isfinite(got).all().item(), f"{name} {shape}: non-finite output")
        require(bad == 0, f"{name} {shape}: kernel disagrees with its plain version")
        max_err[name] = max(max_err.get(name, 0.0), err)

    # -- 3. kernels against their plain versions ---------------------------
    with torch.inference_mode():
        for batch in (1024, 1000):
            xi, wh, bh = gru_inputs(batch)
            compare("gru_v2", gru_v2.gru_last_state_v2(xi, wh, bh),
                    gru_v2.gru_last_state_v2_reference(xi, wh, bh),
                    GRU_ATOL, 0.0, f"B={batch} T={Q_LEN} H={HIDDEN}")
        for rows in (1024 * OBJS, 1000 * OBJS + 5):
            x_q, scale, w = gemm_inputs(rows)
            compare("dequant_matmul", feed_gemm.dequant_matmul(x_q, scale, w),
                    feed_gemm.dequant_matmul_reference(x_q, scale, w),
                    BF16_ATOL, BF16_RTOL, f"M={rows} K={V_DIM} N={HIDDEN}")
        for batch in (1024, 1003):
            w, x_q = pool_inputs(batch)
            compare("pool_int8", lazyv_pool.pool_int8(w, x_q),
                    lazyv_pool.pool_int8_reference(w, x_q),
                    BF16_ATOL, BF16_RTOL, f"B={batch} N={OBJS} D={V_DIM}")

    # -- 4. serve a few requests through the port's main path --------------
    dims = dict(encoder_type="base", predictor_type="base", decoder_type="none",
                ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
                ans_dim=ANS, dropout=0.2, att_type="new")
    model = set_model(**dims, use_pallas=True,
                      generator=torch.Generator().manual_seed(0))
    model = model.to(device=dev, dtype=bf16).eval()
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_root(root, split="val2014", num_images=64,
                            num_questions=SERVE_BATCH * SERVE_REQUESTS,
                            num_objs=OBJS, v_dim=V_DIM, vocab_size=NTOKEN,
                            num_answers=ANS, q_len=Q_LEN, seed=0)
        dataset = set_dataset(os.path.join(root, "annot"),
                              os.path.join(root, "features"), ANS,
                              is_val=True, dataset_type="vqa",
                              feature_mode="int8")
        host_batches = list(Loader(dataset, SERVE_BATCH, drop_last=True))
    require(len(host_batches) == SERVE_REQUESTS,
            f"loader gave {len(host_batches)} batches")
    requests = [{"q": torch.from_numpy(b["q"]).to(dev, torch.long),
                 "img_q": torch.from_numpy(b["img_q"]).to(dev),
                 "img_scale": torch.from_numpy(b["img_scale"]).to(dev, bf16),
                 "a": torch.from_numpy(b["a"]).to(dev)} for b in host_batches]

    with torch.inference_mode():
        _build.reset_launches()
        served = [model.forward_vqa(r) for r in requests]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        log(f"serve: {SERVE_REQUESTS} requests of B={SERVE_BATCH} through "
            f"VQAModel.forward_vqa; kernel launches {launches}")
        for name in KERNELS:
            require(launches[name] > 0, f"the main path never launched {name}")
        for score, label, target in served:
            require(score.shape == (SERVE_BATCH, ANS) and label.shape == (SERVE_BATCH,),
                    f"forward_vqa shapes {tuple(score.shape)}, {tuple(label.shape)}")
            require(torch.isfinite(score).all().item(), "non-finite scores")

        got = [model(r)[0] for r in requests]
        with ExitStack() as stack:
            plain_kernels(stack, gru_v2, feed_gemm, lazyv_pool)
            want = [model(r)[0] for r in requests]
        got, want = torch.cat(got).float(), torch.cat(want).float()
        require(got.shape == (SERVE_BATCH * SERVE_REQUESTS, ANS), f"logits {tuple(got.shape)}")
        require(torch.isfinite(got).all().item(), "non-finite logits")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        log(f"serve: logits vs the same model on plain versions: max abs err / "
            f"max |logit| = {rel:.3g} (tolerance {LOGIT_REL_TOL:g}), max |logit| "
            f"{want.abs().max().item():.3g}, argmax agreement {agree:.4f}, "
            f"nonzero logits {(want > 0).float().mean().item():.3f}")
        require(rel <= LOGIT_REL_TOL, "logits disagree with the plain versions")

    # -- 5. timing at B=16384 ----------------------------------------------
    times = {}
    with torch.inference_mode():
        xi, wh, bh = gru_inputs(TIME_BATCH)
        times["gru_v2"] = time_pair(lambda: gru_v2.gru_last_state_v2(xi, wh, bh),
                                    lambda: gru_v2.gru_last_state_v2_reference(xi, wh, bh), 10)
        del xi, wh, bh
        x_q, scale, w = gemm_inputs(TIME_BATCH * OBJS)
        times["dequant_matmul"] = time_pair(
            lambda: feed_gemm.dequant_matmul(x_q, scale, w),
            lambda: feed_gemm.dequant_matmul_reference(x_q, scale, w), 5)
        del x_q, scale, w
        w, x_q = pool_inputs(TIME_BATCH)
        times["pool_int8"] = time_pair(lambda: lazyv_pool.pool_int8(w, x_q),
                                       lambda: lazyv_pool.pool_int8_reference(w, x_q), 10)
        del w, x_q
        for name, (k_ms, p_ms) in times.items():
            log(f"time {name} B={TIME_BATCH}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms [{card}]")

        plain_model = set_model(**dims, use_pallas=False).to(device=dev, dtype=bf16).eval()
        plain_model.load_state_dict(model.state_dict())
        x_q, scale = int8_feed(TIME_BATCH * OBJS, V_DIM)
        batch = {"q": torch.randint(0, NTOKEN, (TIME_BATCH, Q_LEN), device=dev, generator=gen),
                 "img_q": x_q.view(TIME_BATCH, OBJS, V_DIM),
                 "img_scale": scale.view(TIME_BATCH, OBJS)}
        fwd_k, fwd_p = time_pair(lambda: model(batch), lambda: plain_model(batch), 3)
        log(f"time forward B={TIME_BATCH} int8 feed bf16: kernels {fwd_k:.3f} ms "
            f"({TIME_BATCH / fwd_k * 1e3:.1f} q/s), plain {fwd_p:.3f} ms "
            f"({TIME_BATCH / fwd_p * 1e3:.1f} q/s) [{card}]")

    entries = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": launches[name], "max_abs_err": max_err[name],
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name in KERNELS]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
