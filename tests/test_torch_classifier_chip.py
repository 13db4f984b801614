"""The answer classifier's last layer on the card, at the staged answering
batch (B=32768) and Up-Down's widths ([B, 2048] x [2048, 3129]): the
product at the padded width 3136 leaves cuBLAS's sm75 fallback kernel,
takes under 1 ms, and its logits agree with the unpadded form (the
product, then the bias in bf16) within one bf16 ulp plus the rounding of
the product before the bias.

Marked ``chip``; each test skips without a CUDA card. This file imports no
JAX, so on a machine with the card and no JAX it runs without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -m chip tests/test_torch_classifier_chip.py -q
"""

from __future__ import annotations

import pytest
import torch

from vqa_tpu_torch.ops import linear

pytestmark = pytest.mark.chip

BF16 = torch.bfloat16
BATCH, HIDDEN2, ANS = 32768, 2048, 3129
LAYER_MS = 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def layer_and_input(cuda):
    gen = torch.Generator().manual_seed(24)
    layer = linear.WNDense(HIDDEN2, ANS, generator=gen).to(cuda, BF16).eval()
    g = torch.Generator(device=cuda).manual_seed(24)
    # the classifier's hidden layer is a ReLU's output
    x = torch.relu(torch.randn(BATCH, HIDDEN2, device=cuda, dtype=BF16, generator=g))
    return layer, x


def test_classifier_gemm_leaves_the_sm75_fallback(layer_and_input):
    from torch.profiler import ProfilerActivity, profile
    layer, x = layer_and_input
    with torch.inference_mode():
        layer(x)
        torch.cuda.synchronize()
        linear.reset_routes()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            layer(x)
            torch.cuda.synchronize()
    assert linear.ROUTES == {"aligned": 1, "plain": 0}
    names = [e.key for e in prof.key_averages()
             if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    gemms = [n for n in names if any(k in n for k in ("gemm", "nvjet", "cutlass", "Gemm"))]
    assert len(gemms) == 1, names
    assert not any("cutlass_75" in n for n in names), names


def test_classifier_layer_time(layer_and_input):
    layer, x = layer_and_input
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode():
        for _ in range(3):
            layer(x)
        start.record()
        for _ in range(20):
            layer(x)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 20
    assert ms < LAYER_MS, ms


def test_classifier_logits_match_the_unpadded_form(layer_and_input):
    layer, x = layer_and_input
    with torch.inference_mode():
        got = layer(x)
        w = layer.weight(BF16)
        product = torch.matmul(x, w.t())
        want = product + layer.bias
        # the two GEMMs accumulate in f32 in different orders, each within
        # 8 sqrt(K) 2**-24 of sum_k |x_k w_k| (Higham and Mary's
        # probabilistic bound; the worst case, K 2**-24, is 45 times
        # looser): the floor of the difference where the product and the
        # bias are both near 0
        accum = (16 * HIDDEN2 ** 0.5 * 2.0 ** -24) * torch.matmul(
            x.float().abs(), w.float().abs().t())
        torch.cuda.synchronize()
    assert got.shape == (BATCH, ANS) and got.dtype == BF16
    got, want, product = got.float(), want.float(), product.float()
    # one ulp of the output, plus half an ulp of the product that the
    # unpadded form rounds before it adds the bias
    tol = (torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
           + product.abs() * 2.0 ** -8 + accum)
    over = (got - want).abs() - tol
    worst = int(over.argmax())
    r, c = divmod(worst, ANS)
    assert bool((over <= 0).all()), (
        f"[{r}, {c}]: got {got[r, c].item()}, want {want[r, c].item()}, "
        f"product {product[r, c].item()}, bias {layer.bias[c].item()}, "
        f"tol {tol[r, c].item()}, accum {accum[r, c].item()}; "
        f"{int((over > 0).sum())} over")
