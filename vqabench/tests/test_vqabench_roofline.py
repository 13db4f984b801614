"""The yardstick's counts against hand counts at small shapes: the model
FLOPs against torch's FLOP counter over the plain reference (forward, and
forward with backward), each kernel's bytes against the tensors of its
call, and the bound's choice of term."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vqabench import manifest, roofline
from vqabench.common import make_weights
from vqabench.reference import train as ref_train
from vqabench.reference import updown
from vqabench.reference.precision import Precision
from vqabench.tests.conftest import TINY_CONFIG

B = 4


def _params(caption: bool):
    from vqa_tpu_torch.models.wrapper import set_model

    cfg = dict(manifest.config(manifest.load(), "vqae-mtl" if caption
                               else "updown-vqa"))
    cfg.update({k: v for k, v in TINY_CONFIG.items()
                if k in cfg or k in ("decoder_hidden_dim", "c_len")})
    model = set_model(**{k: cfg[k] for k in ("encoder_type", "predictor_type",
                                             "decoder_type", "ntoken", "v_dim",
                                             "embed_dim", "hidden_dim",
                                             "decoder_hidden_dim", "ans_dim",
                                             "c_len", "att_type", "use_mtl")
                         if k in cfg}, device="cpu")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    return cfg, make_weights(shapes, 5, "cpu", torch.float32)


def _batch(cfg, caption: bool):
    g = torch.Generator().manual_seed(3)
    N, D = cfg["num_objs"], cfg["v_dim"]
    batch = {"q": torch.randint(0, cfg["ntoken"], (B, cfg["q_len"]), generator=g),
             "img_q": torch.randint(-127, 128, (B, N, D), generator=g).to(torch.int8),
             "img_scale": torch.rand((B, N), generator=g) / 100,
             "a": (torch.rand((B, cfg["ans_dim"]), generator=g) < 0.2).float()}
    if caption:
        batch["c"] = torch.randint(0, cfg["ntoken"], (B, cfg["c_len"]), generator=g)
        batch["cap_len"] = torch.full((B,), cfg["c_len"], dtype=torch.int32)
    return batch


def test_answer_flops_count_the_reference_forward():
    cfg, P = _params(False)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        updown.answer(P, _batch(cfg, False), Precision())
    assert counter.get_total_flops() == B * roofline.answer_flops(cfg)


@pytest.mark.parametrize("caption", [False, True])
def test_train_flops_count_the_reference_forward_and_backward(caption):
    cfg, P = _params(caption)
    P = {k: v.requires_grad_(True) for k, v in P.items()}
    batch = _batch(cfg, caption)
    counter = FlopCounterMode(display=False)
    with counter:
        ref_train.loss_and_grads(P, batch, 7, 0, cfg, Precision(), B,
                                 torch.bfloat16)
    steps = cfg["c_len"] - 1 if caption else 0
    assert counter.get_total_flops() == B * roofline.train_flops(cfg, steps)


def nbytes(*shapes_dtypes):
    return sum(torch.empty(s, dtype=d).nbytes for s, d in shapes_dtypes)


BF, I8 = torch.bfloat16, torch.int8


@pytest.mark.parametrize("Bt,T,H", [(8, 5, 32), (24, 10, 64)])
def test_gru_v2_counts(Bt, T, H):
    least, what = roofline.gru_v2(Bt, T, H)
    n = nbytes(((Bt, T, 3 * H), BF), ((H, 3 * H), BF), ((3 * H,), BF),
               ((Bt, H), BF))
    ops = 2 * Bt * 3 * H * (T - 1) * H
    assert least == max(n / 3.35e12, ops / 989e12)
    assert what == ("bytes" if n / 3.35e12 > ops / 989e12 else "operations")


def test_dequant_matmul_and_pool_counts():
    M, K, N = 72, 64, 48
    n = nbytes(((M, K), I8), ((M,), BF), ((K, N), BF), ((M, N), BF))
    assert roofline.dequant_matmul(M, K, N)[0] == max(n / 3.35e12,
                                                       2 * M * K * N / 989e12)
    b, boxes, d = 8, 6, 32
    n = nbytes(((b, boxes), BF), ((b, boxes, d), I8), ((b, d), BF))
    assert roofline.pool_int8(b, boxes, d) == (n / 3.35e12, "bytes")


def test_decode_attention_counts():
    b, boxes, H, D, T = 8, 6, 32, 48, 5
    fwd = nbytes(((b, boxes * H), BF), ((b, boxes * D), I8), ((b, boxes), BF),
                 ((b, H), BF), ((H,), BF), ((b, boxes), BF), ((b, D), BF))
    bwd = nbytes(((b, boxes * H), BF), ((b, boxes * D), I8), ((b, boxes), BF),
                 ((b, boxes), BF), ((b, D), BF), ((b, H), BF),
                 ((b, boxes), BF), ((b, boxes), BF))
    dvp = nbytes(((T, b, boxes), BF), ((T, b, H), BF), ((H,), BF),
                 ((b, boxes * H), BF))
    draws = b * boxes * (H // 16)
    philox = draws * 40 / (67e12 / 2)
    ops = 2 * b * boxes * (H + D)
    assert roofline.decode_att_fwd(b, boxes, H, D)[0] == max(
        fwd / 3.35e12, ops / 67e12, philox)
    assert roofline.decode_att_bwd(b, boxes, H, D)[0] == max(
        bwd / 3.35e12, ops / 67e12, philox)
    assert roofline.decode_att_dvp(T, b, boxes, H)[0] == max(
        dvp / 3.35e12, 2 * T * b * boxes * H / 67e12, philox * T)
