"""``WNDense.forward``'s aligned route: an unsharded layer whose output
width is over 8 and not a multiple of 8 runs its product at the width
padded to the next multiple of 8 (zero weight rows and bias entries, the
bias in the product's epilogue) and returns the first ``out_dim`` columns.

Held against the plain form ``x @ W.T + b`` (the bias after the product's
rounding): equal in f32, within one bf16 ulp in bf16; the gradients of
every parameter through ``FCNet``; the parameters and ``state_dict``
unchanged; ``linear.ROUTES`` by width, under a tensor-parallel slice, and
once a forward in the answering models.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops import linear
from vqa_tpu_torch.ops.linear import FCNet, WNDense

BF16, F32 = torch.bfloat16, torch.float32
B, IN = 6, 64


def plain(layer: WNDense, x: torch.Tensor) -> torch.Tensor:
    """The unpadded form: the product, then the bias in the input's dtype."""
    y = torch.matmul(x, layer.weight(x.dtype).t())
    return y + layer.bias.to(y.dtype)


def plain_fcnet(net: FCNet, x: torch.Tensor) -> torch.Tensor:
    for slot in net.main:
        x = plain(slot, x) if isinstance(slot, WNDense) else slot(x)
    return x


def layer_and_input(out_dim: int, dtype: torch.dtype, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    layer = WNDense(IN, out_dim, generator=gen)
    x = torch.randn(B, IN, generator=gen).to(dtype)
    return layer, x


@pytest.mark.parametrize("out_dim", [3129, 13])
def test_aligned_route_equals_the_plain_form_in_f32(out_dim):
    layer, x = layer_and_input(out_dim, F32)
    linear.reset_routes()
    with torch.no_grad():
        got, want = layer(x), plain(layer, x)
    assert linear.ROUTES == {"aligned": 1, "plain": 0}
    assert got.shape == (B, out_dim) and got.dtype == F32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("out_dim", [3129, 13])
def test_aligned_route_within_one_bf16_ulp_of_the_plain_form(out_dim):
    """One rounding of product + bias against the product's rounding, then
    the sum's: they differ by at most one bf16 ulp of the output plus half
    an ulp of the product, plus the f32 accumulation's order (each GEMM
    within 8 sqrt(K) 2**-24 of sum_k |x_k w_k|, Higham and Mary's
    probabilistic bound)."""
    layer, x = layer_and_input(out_dim, BF16, seed=1)
    with torch.no_grad():
        got = layer(x).float()
        w = layer.weight(BF16)
        product = torch.matmul(x, w.t()).float()
        want = plain(layer, x).float()
        accum = 16 * IN ** 0.5 * 2.0 ** -24 * (x.float().abs() @ w.float().abs().t())
    assert layer(x).dtype == BF16
    tol = (torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
           + product.abs() * 2.0 ** -8 + accum)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("ans_dim", [3129, 13])
def test_fcnet_gradients_match_the_plain_form(ans_dim):
    """The classifier's FCNet (two layers, the last misaligned) at f32:
    the output and the gradients of x and of every weight_v, weight_g and
    bias equal the plain form's."""
    gen = torch.Generator().manual_seed(2)
    net = FCNet(IN, ans_dim, mid_dim=2 * IN, layer=2, dropout=0.0,
                generator=gen)
    x = torch.randn(B, IN, generator=gen)
    r = torch.randn(B, ans_dim, generator=gen)
    grads = []
    for form in (net, lambda t: plain_fcnet(net, t)):
        net.zero_grad()
        xg = x.clone().requires_grad_(True)
        out = form(xg)
        (out * r).sum().backward()
        grads.append([out.detach(), xg.grad]
                     + [p.grad for _, p in net.named_parameters()])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())


def test_parameters_and_state_dict_unchanged():
    net = FCNet(IN, 3129, mid_dim=2 * IN, layer=2,
                generator=torch.Generator().manual_seed(3))
    want = {"main.0.weight_v": (2 * IN, IN), "main.0.weight_g": (),
            "main.0.bias": (2 * IN,), "main.3.weight_v": (3129, 2 * IN),
            "main.3.weight_g": (), "main.3.bias": (3129,)}
    with torch.no_grad():
        net(torch.randn(B, IN))
    assert {k: tuple(p.shape) for k, p in net.named_parameters()} == want
    assert {k: tuple(t.shape) for k, t in net.state_dict().items()} == want


@pytest.mark.parametrize("lead", [(B,), (B, 3)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_output_shape_and_contiguity_after_the_relu(lead, dtype):
    """The layer returns a view of the padded product; FCNet's trailing ReLU
    writes it out contiguous at [*, out_dim]."""
    net = FCNet(IN, 3129, generator=torch.Generator().manual_seed(4))
    net = net.to(dtype)
    with torch.no_grad():
        x = torch.randn(*lead, IN).to(dtype)
        y = net(x)
        assert not net.main[0](x).is_contiguous()
    assert y.shape == (*lead, 3129) and y.dtype == dtype
    assert y.is_contiguous()


class _IdentityShard:
    """A tensor-parallel slot whose collectives are the identity (one
    rank): enough to select the sharded layer's path."""

    def enter(self, x):
        return x

    def total(self, x):
        return x

    def gather(self, y):
        return y


@pytest.mark.parametrize("out_dim,route", [(3129, "aligned"), (13, "aligned"),
                                           (1, "plain"), (8, "plain"),
                                           (1024, "plain"), (2048, "plain")])
def test_routes_count_by_output_width(out_dim, route):
    layer, x = layer_and_input(out_dim, F32, seed=5)
    linear.reset_routes()
    with torch.no_grad():
        for _ in range(3):
            layer(x)
    assert linear.ROUTES == {"aligned": 3 * (route == "aligned"),
                             "plain": 3 * (route == "plain")}


def test_sharded_layer_keeps_the_plain_form():
    layer, x = layer_and_input(3129, F32, seed=6)
    layer.tp = _IdentityShard()
    linear.reset_routes()
    with torch.no_grad():
        got = layer(x)
        want = plain(layer, x)
    assert linear.ROUTES == {"aligned": 0, "plain": 1}
    assert torch.equal(got, want)


ENCODERS = {
    "base": dict(encoder_type="base"),
    "relation": dict(encoder_type="relation", conv_layer=1, conv_type="corr",
                     use_spa=True, use_imp=False),
}


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_answering_forward_counts_one_aligned_call(encoder):
    """The base predictor at a misaligned answer count: its classifier's
    last layer is the one aligned call of a forward."""
    objs, v_dim, ans = 4, 32, 13
    model = set_model(**ENCODERS[encoder], predictor_type="base",
                      decoder_type="none", ntoken=30, v_dim=v_dim,
                      embed_dim=8, hidden_dim=32, ans_dim=ans, att_type="new",
                      generator=torch.Generator().manual_seed(7),
                      device="cpu").eval()
    rng = np.random.default_rng(7)
    batch = {"q": torch.from_numpy(rng.integers(0, 30, (B, 5))),
             "img_q": torch.from_numpy(rng.integers(-127, 128, (B, objs, v_dim),
                                                    dtype=np.int8)),
             "img_scale": torch.full((B, objs), 0.02),
             "graph": torch.from_numpy(rng.integers(0, 12, (B, objs, objs)))}
    linear.reset_routes()
    with torch.no_grad():
        for _ in range(2):
            logits = model(batch)[0]
    assert logits.shape == (B, ans)
    assert linear.ROUTES["aligned"] == 2
    assert linear.ROUTES["plain"] > 0
