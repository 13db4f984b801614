"""The int8 feed's attended features ``v = v_att * (img_q * img_scale)``:
``lazyv_pool.attended_int8``'s plain version against the eager form and an
independent bit-level oracle, its rule against the wrapper's refusals on
meta tensors, and the encoder's route (``encoder.ROUTES``): the kernel
where the model serves in bf16 with ``use_pallas`` and the rule takes the
shapes, the plain form everywhere else, with the same bits. On the CPU the
wrapper runs its plain version; ``tests/test_torch_attended_int8_chip.py``
holds the kernel to it on the card.
"""

import numpy as np
import pytest
import torch

from vqa_tpu_torch.models import encoder as encoder_mod
from vqa_tpu_torch.models.encoder import BaseEncoder
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops import quant
from vqa_tpu_torch.ops.kernels import _build, lazyv_pool

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS = 4, 5, 12, 32, 64, 6, 30, 20
REGAT = dict(encoder_type="relation", predictor_type="base", decoder_type="none",
             ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
             ans_dim=ANS, dropout=0.2, att_type="new", conv_layer=1,
             conv_type="corr", use_spa=True, use_imp=False)


def operands(seed, b=B, n=OBJS, d=V_DIM, dtype=BF16):
    """Box weights (a softmax, with a few boxes near 0), per-box scales as
    the feed's absmax / 127 of unit-normal features, and the payload."""
    gen = torch.Generator().manual_seed(seed)
    logits = 6 * torch.randn(b, n, generator=gen)
    att = torch.softmax(logits, dim=-1).to(dtype)
    scale = ((2.5 + 2 * torch.rand(b, n, generator=gen)) / 127).to(dtype)
    x_q = torch.randint(-127, 128, (b, n, d), generator=gen, dtype=I8)
    return att, scale, x_q


def bf16_rne(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest, ties to even) by their
    bits, returned as float32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32)


def oracle(att: torch.Tensor, scale: torch.Tensor, x_q: torch.Tensor) -> np.ndarray:
    """bf16(att * bf16(x_q * scale)) in numpy: each product exact in
    float64, then rounded once to bf16."""
    a = att.float().numpy().astype(np.float64)[..., None]
    s = scale.float().numpy().astype(np.float64)[..., None]
    v = bf16_rne((x_q.numpy().astype(np.float64) * s).astype(np.float32))
    return bf16_rne((a * v.astype(np.float64)).astype(np.float32))


def regat_batch(seed, b=B, v_dim=V_DIM, scale_dtype=BF16):
    rng = np.random.default_rng(seed)
    return {"q": torch.from_numpy(rng.integers(0, NTOKEN, (b, Q_LEN))),
            "img_q": torch.from_numpy(rng.integers(-127, 128, (b, OBJS, v_dim),
                                                   dtype=np.int8)),
            "img_scale": torch.from_numpy(
                (2.5 + 2 * rng.random((b, OBJS))) / 127).to(scale_dtype),
            "graph": torch.from_numpy(rng.integers(0, 12, (b, OBJS, OBJS))
                                      .astype(np.int32))}


def regat(dtype=BF16, **over):
    model = set_model(**{**REGAT, "use_pallas": True, **over},
                      generator=torch.Generator().manual_seed(5), device="cpu")
    return model.to(dtype).eval()


@pytest.fixture(autouse=True)
def routes():
    encoder_mod.reset_routes()
    yield encoder_mod.ROUTES
    encoder_mod.reset_routes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_is_the_eager_form_in_bf16(seed):
    att, scale, x_q = operands(seed)
    got = lazyv_pool.attended_int8_reference(att, scale, x_q)
    want = att[..., None] * quant.dequantize(x_q, scale)
    assert got.dtype == BF16 and got.shape == x_q.shape
    assert torch.equal(got, want)
    # PyTorch's two rounding points, against the bits computed apart
    np.testing.assert_array_equal(got.float().numpy(), oracle(att, scale, x_q))


def test_reference_in_f32_is_the_eager_form_within_round_off():
    att, scale, x_q = operands(3, dtype=F32)
    got = lazyv_pool.attended_int8_reference(att, scale, x_q)
    want = att[..., None] * quant.dequantize(x_q, scale)
    exact = (att.double()[..., None] * x_q.double() * scale.double()[..., None])
    assert got.dtype == F32
    torch.testing.assert_close(got, want, rtol=2 * 2.0 ** -24, atol=0)
    torch.testing.assert_close(got.double(), exact, rtol=2 * 2.0 ** -24, atol=0)


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))


def meta(*shape, dtype=BF16):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("b, n, d, att_dtype, scale_dtype", [
    (8192, 36, 2048, BF16, BF16), (3, 5, 16, BF16, BF16), (4, 36, 40, BF16, BF16),
    (4, 36, 2040, BF16, BF16), (4, 36, 32, F32, BF16), (4, 36, 32, BF16, F32),
    (2 ** 16, 256, 2048, BF16, BF16)])
def test_supports_attended_matches_the_wrapper(no_nvcc, b, n, d, att_dtype,
                                               scale_dtype):
    """``supports_attended`` holds exactly where the wrapper passes its
    checks and asks for the build (meta tensors, no nvcc)."""
    want = lazyv_pool.supports_attended(b, n, d, att_dtype, scale_dtype)
    assert want == (d % 16 == 0 and b * n * d < 2 ** 35
                    and att_dtype == scale_dtype == BF16)
    before = dict(_build.LAUNCHES)
    try:
        lazyv_pool.attended_int8(meta(b, n, dtype=att_dtype),
                                 meta(b, n, dtype=scale_dtype),
                                 meta(b, n, d, dtype=I8))
    except _build.KernelBuildError:
        reached = True
    except (ValueError, TypeError):
        reached = False
    assert reached == want
    assert _build.LAUNCHES == before


def test_wrapper_refuses_mismatched_shapes(no_nvcc):
    with pytest.raises(ValueError):
        lazyv_pool.attended_int8(meta(4, 6), meta(4, 5), meta(4, 6, 32, dtype=I8))


def test_regat_serving_takes_the_kernel_once_a_forward(routes, monkeypatch):
    calls = []
    real = lazyv_pool.attended_int8

    def spy(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(lazyv_pool, "attended_int8", spy)
    model, batch = regat(), regat_batch(0)
    with torch.no_grad():
        for _ in range(2):
            model(batch)
    assert routes == {"kernel": 2, "plain": 0}
    assert calls == [(B, OBJS, V_DIM)] * 2


@pytest.mark.parametrize("case", ["training", "f32", "no_use_pallas", "d_refused",
                                  "use_int8_f32"])
def test_regat_takes_the_plain_form_elsewhere(routes, case):
    v_dim = 40 if case == "d_refused" else V_DIM
    dtype = F32 if case in ("f32", "use_int8_f32") else BF16
    over = {"v_dim": v_dim}
    if case == "no_use_pallas":
        over["use_pallas"] = False
    if case == "use_int8_f32":
        over["use_int8"] = True
    model = regat(dtype, **over)
    if case == "training":
        model.train()
    batch = regat_batch(1, v_dim=v_dim, scale_dtype=dtype)
    with torch.no_grad():
        model(batch)
    assert routes == {"kernel": 0, "plain": 1}


def test_updown_forms_no_attended_features(routes):
    model = set_model(**{**REGAT, "encoder_type": "base"}, use_pallas=True,
                      generator=torch.Generator().manual_seed(5), device="cpu")
    model = model.to(BF16).eval()
    batch = regat_batch(2)
    batch.pop("graph")
    with torch.no_grad():
        model(batch)
    assert routes == {"kernel": 0, "plain": 0}


@pytest.mark.parametrize("route", ["gated", "use_int8", "plain"])
def test_attend_feed_forms_the_features_only_on_the_plain_route(route, monkeypatch):
    """The gated GEMM reads the payload and the int8 GEMM's ``v_cache``
    replaces the features: neither route dequantizes them; the plain
    route's attention reads them and hands them on."""
    enc = BaseEncoder(NTOKEN, V_DIM, EMBED, HIDDEN, att_type="new", use_pallas=True,
                      use_int8=route == "use_int8", with_v=True,
                      generator=torch.Generator().manual_seed(3)).eval().to(BF16)
    if route == "plain":
        monkeypatch.setattr(enc, "_on_kernels", lambda scale: False)
    batch = regat_batch(3)
    dequantized = []
    real = encoder_mod.dequantize

    def spy(*args):
        dequantized.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(encoder_mod, "dequantize", spy)
    q = torch.randn(B, HIDDEN).to(BF16)
    with torch.no_grad():
        v_att, v = enc.attend_feed(batch["img_q"], batch["img_scale"], q)
    assert v_att.shape == (B, OBJS, 1)
    if route == "plain":
        assert dequantized == [(B, OBJS, V_DIM)]
        assert torch.equal(v, real(batch["img_q"], batch["img_scale"]))
    else:
        assert v is None and dequantized == []


@pytest.mark.parametrize("use_int8", [False, True])
def test_regat_features_and_logits_match_the_plain_form_bit_for_bit(
        routes, monkeypatch, use_int8):
    model, batch = regat(use_int8=use_int8), regat_batch(4)
    with torch.no_grad():
        v_kernel = model.encoder._visual(batch)
        logits_kernel = model(batch)[0]
        assert routes["kernel"] == 2
        monkeypatch.setattr(lazyv_pool, "supports_attended", lambda *a: False)
        v_plain = model.encoder._visual(batch)
        logits_plain = model(batch)[0]
    assert routes["plain"] == 2
    assert v_kernel["v"].dtype == BF16
    assert torch.equal(v_kernel["v"], v_plain["v"])
    assert torch.equal(v_kernel["v"], v_plain["v_att"] * quant.dequantize(
        batch["img_q"], batch["img_scale"]))
    assert torch.equal(logits_kernel, logits_plain)


def test_a_caption_encoder_serving_takes_the_kernel(routes):
    """``with_v`` outside ReGAT (the caption decoders, q-cap): the same
    route, the same bits as the plain product."""
    enc = BaseEncoder(NTOKEN, V_DIM, EMBED, HIDDEN, att_type="new", use_pallas=True,
                      with_v=True, generator=torch.Generator().manual_seed(6))
    enc = enc.eval().to(BF16)
    batch = regat_batch(5)
    with torch.no_grad():
        out = enc(batch)
    assert routes == {"kernel": 1, "plain": 0}
    assert torch.equal(out["v"], out["v_att"] * quant.dequantize(
        batch["img_q"], batch["img_scale"]))
