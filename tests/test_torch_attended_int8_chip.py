"""The int8 feed's attended features on the card: ``attended_int8``
(``csrc/lazyv_pool.cu``) equal to the plain form bit for bit at ReGAT's
served batch (B=8192, 36 boxes of 2048), at B=3 and at a ragged B=8191,
under 0.75 ms at B=8192 (its bytes bound is 0.54 ms), and a profiled
ReGAT forward at B=8192 with one launch of it and no cast of the
[8192, 36, 2048] payload.

Marked ``chip``; each test skips without a CUDA card. This file imports no
JAX, so on a machine with the card and no JAX it runs without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -m chip tests/test_torch_attended_int8_chip.py -q
"""

from __future__ import annotations

import pytest
import torch

from vqa_tpu_torch.models import encoder as encoder_mod
from vqa_tpu_torch.ops.kernels import _build, lazyv_pool

pytestmark = pytest.mark.chip

BF16 = torch.bfloat16
BATCH, OBJS, V_DIM = 8192, 36, 2048
KERNEL_MS = 0.75
REGAT_DIMS = dict(encoder_type="relation", predictor_type="base", decoder_type="none",
                  ntoken=20000, v_dim=V_DIM, embed_dim=300, hidden_dim=1024,
                  ans_dim=3129, att_type="new", conv_layer=1, conv_type="corr",
                  use_spa=True, use_imp=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def operands(dev, batch, seed=26):
    """Box weights (a softmax over the boxes), the feed's per-box scales
    (absmax / 127 of unit-normal features) and the payload."""
    g = torch.Generator(device=dev).manual_seed(seed)
    att = torch.softmax(4 * torch.randn(batch, OBJS, device=dev, generator=g),
                        dim=-1).to(BF16)
    scale = ((2.5 + 2 * torch.rand(batch, OBJS, device=dev, generator=g)) / 127).to(BF16)
    x_q = torch.randint(-127, 128, (batch, OBJS, V_DIM), device=dev, generator=g,
                        dtype=torch.int8)
    return att, scale, x_q


@pytest.mark.parametrize("batch", [BATCH, 3, BATCH - 1])
def test_attended_int8_equals_the_plain_form(cuda, batch):
    att, scale, x_q = operands(cuda, batch)
    assert lazyv_pool.supports_attended(batch, OBJS, V_DIM, att.dtype, scale.dtype)
    with torch.inference_mode():
        before = _build.LAUNCHES["attended_int8"]
        got = lazyv_pool.attended_int8(att, scale, x_q)
        want = lazyv_pool.attended_int8_reference(att, scale, x_q)
        torch.cuda.synchronize()
    assert _build.LAUNCHES["attended_int8"] == before + 1
    assert got.dtype == BF16 and got.shape == (batch, OBJS, V_DIM)
    assert torch.equal(got, want), int((got != want).sum())


def test_attended_int8_time(cuda):
    att, scale, x_q = operands(cuda, BATCH)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode():
        for _ in range(3):
            lazyv_pool.attended_int8(att, scale, x_q)
        start.record()
        for _ in range(20):
            lazyv_pool.attended_int8(att, scale, x_q)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 20
    assert ms < KERNEL_MS, ms


def test_regat_forward_launches_the_kernel_and_casts_no_payload(cuda):
    from torch.profiler import ProfilerActivity, profile

    from vqa_tpu_torch.models.wrapper import set_model

    model = set_model(**REGAT_DIMS, use_pallas=True,
                      generator=torch.Generator().manual_seed(26), device=cuda)
    model = model.to(BF16).eval()
    att, scale, x_q = operands(cuda, BATCH)
    g = torch.Generator(device=cuda).manual_seed(7)
    batch = {"q": torch.randint(0, 20000, (BATCH, 10), device=cuda, generator=g),
             "img_q": x_q, "img_scale": scale,
             "graph": torch.randint(0, 12, (BATCH, OBJS, OBJS), device=cuda,
                                    generator=g, dtype=torch.int32)}
    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        encoder_mod.reset_routes()
        _build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            model(batch)
            torch.cuda.synchronize()
    assert encoder_mod.ROUTES == {"kernel": 1, "plain": 0}
    assert _build.LAUNCHES["attended_int8"] == 1
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type.name == "CUDA" and "attended_int8_kernel" in e.key]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    payload = [BATCH, OBJS, V_DIM]
    casts = [(e.key, e.input_shapes) for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::copy_", "aten::_to_copy", "aten::to")
             and payload in (e.input_shapes or [])]
    assert casts == [], casts
