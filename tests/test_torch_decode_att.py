"""The decode-attention kernels' plain versions and their Philox mask.

vqa_tpu_torch/ops/kernels/decode_att.py holds the plain PyTorch versions of
the three CUDA kernels (decode_att_fwd, decode_att_bwd, decode_att_dvp) and
the counter-based keep mask that all of them draw. Here, on the CPU:

- the mask's generator against the Random123 known-answer vectors of
  Philox4x32-10, its independence from how the batch is split, and its keep
  rate;
- each plain version against vqa_tpu's Pallas kernel in interpret mode and
  its pure-JAX reference, both given the port's mask as the explicit mask,
  in the input regimes of tests/test_pallas.py (f32; bf16 with a dense bf16
  pool; bf16 with an int8 pool and factored weights), at its shapes and its
  tolerances;
- the hand-written backward formulas against torch.autograd of the plain
  forward with the mask held fixed.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vqa_tpu.ops.pallas import decode_att as jda
from vqa_tpu_torch.ops.kernels import _build
from vqa_tpu_torch.ops.kernels import decode_att as da

B, OBJS, H, D = 8, 5, 16, 12
SCALE = 256.0 / 205
SEED, STEP = 0x1234ABCD, 3


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = da.philox4x32_10([t(c) for c in counter], [t(k) for k in key])
    assert tuple(int(w) for w in got) == want


def test_keep_mask_layout_and_batch_split():
    """Lane 16 g + 4 i + j is byte j of word i of the (b, n, g) draw; the
    mask over B rows is the concatenation of the masks of any row split, and
    a vector of steps stacks the per-step masks."""
    mask = da.keep_mask(SEED, STEP, 37, OBJS, 32, 205)
    assert mask.shape == (37, OBJS * 32) and mask.dtype == torch.uint8
    parts = [da.keep_mask(SEED, STEP, n, OBJS, 32, 205, row0=r)
             for r, n in ((0, 1), (1, 15), (16, 21))]
    assert torch.equal(torch.cat(parts), mask)
    steps = da.keep_mask(SEED, [0, STEP, 9], 37, OBJS, 32, 205)
    assert torch.equal(steps[1], mask)
    assert not torch.equal(steps[0], mask)
    # one draw by hand: row 5, box 2, lanes 16..31 (g = 1)
    words = da.philox4x32_10(
        [torch.tensor(v, dtype=torch.int64) for v in (5, 2, 1, 0)],
        (SEED, STEP))
    want = [int((int(words[i]) >> (8 * j)) & 255 < 205)
            for i in range(4) for j in range(4)]
    assert mask[5, 2 * 32 + 16:2 * 32 + 32].tolist() == want
    other = da.keep_mask(SEED, STEP, 37, OBJS, 32, 205, stream=1)
    assert not torch.equal(other, mask)


@pytest.mark.parametrize("thresh", [205, 128])
def test_keep_mask_rate(thresh):
    """The keep rate is thresh / 256 within 4 sigma over 2.4 M lanes."""
    mask = da.keep_mask(SEED, STEP, 64, 36, 1024, thresh)
    p, n = thresh / 256, mask.numel()
    assert abs(mask.double().mean().item() - p) < 4 * math.sqrt(p * (1 - p) / n)


def regime_inputs(rng, regime: str):
    """numpy inputs of one regime (bf16 values as ml_dtypes arrays), as in
    tests/test_pallas.py _decode_att_inputs."""
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    vp, w, qp, k = f(B, OBJS, H), f(B, OBJS), f(B, H), f(1, H)
    if regime == "int8":
        pool = rng.integers(-127, 128, (B, OBJS, D)).astype(np.int8)
    else:
        pool = rng.standard_normal((B, OBJS, D)).astype(np.float32)
    if regime != "f32":
        vp, w, qp, k = (x.astype(ml_dtypes.bfloat16) for x in (vp, w, qp, k))
        if regime == "bf16":
            pool = pool.astype(ml_dtypes.bfloat16)
    return vp, pool, w, qp, k


def to_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (regime, factored): the shipping paths' regimes of tests/test_pallas.py
REGIMES = [("f32", True), ("f32", False), ("bf16", False), ("int8", True)]


@pytest.mark.parametrize("thresh", [205, None])
@pytest.mark.parametrize("regime,factored", REGIMES)
def test_plain_fwd_bwd_match_jax(rng, regime, factored, thresh):
    vp, pool, w, qp, k = regime_inputs(rng, regime)
    wx = w if factored else None
    scale = SCALE if thresh else 1.0
    mask = da.keep_mask(SEED, STEP, B, OBJS, H, thresh or 205)
    m2 = jnp.asarray(mask.numpy())
    tvp, tpool = to_torch(vp).reshape(B, -1), to_torch(pool).reshape(B, -1)
    tw = to_torch(w) if factored else None
    got = da.decode_att_fwd_reference(tvp, tpool, tw, to_torch(qp),
                                      to_torch(k), SEED, STEP, objs=OBJS,
                                      att_scale=scale, thresh=thresh)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    _build.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(got, da.decode_att_fwd(
        tvp, tpool, tw, to_torch(qp), to_torch(k), SEED, STEP, objs=OBJS,
        att_scale=scale, thresh=thresh)))
    assert _build.LAUNCHES["decode_att_fwd"] == 0
    assert got[0].dtype == to_torch(qp).dtype
    jargs = [jnp.asarray(x) for x in (vp, pool, qp, k)]
    jw = jnp.asarray(w) if factored else None
    kern = jda.decode_att_fwd(
        jargs[0].reshape(B, -1), jargs[1].reshape(B, -1), jw, jargs[2],
        jargs[3], None, objs=OBJS, att_scale=scale, thresh=thresh, tile_b=4,
        interpret=True, explicit_mask=m2 if thresh else None)
    ref = jda.fwd_reference(jargs[0], jargs[1], jw, jargs[2], jargs[3],
                            m2.reshape(B, OBJS, H) if thresh else None,
                            att_scale=scale)
    tol = (dict(rtol=1e-2, atol=1e-2) if regime != "f32"
           else dict(rtol=1e-5, atol=1e-6))
    for want in (kern, ref):
        for g, r in zip(got, want):
            np.testing.assert_allclose(f32(g), f32(r), **tol)

    att = got[0]
    gav = (rng.standard_normal((B, D)).astype(np.float32))
    if regime != "f32":
        gav = gav.astype(ml_dtypes.bfloat16)
    bwd = da.decode_att_bwd_reference(tvp, tpool, tw, att, to_torch(gav),
                                      SEED, STEP, objs=OBJS, thresh=thresh)
    jatt = jnp.asarray(f32(att)).astype(jargs[2].dtype)
    kern = jda.decode_att_bwd(
        jargs[0].reshape(B, -1), jargs[1].reshape(B, -1), jw, jatt,
        jnp.asarray(gav), None, objs=OBJS, thresh=thresh, tile_b=4,
        interpret=True, explicit_mask=m2 if thresh else None)
    ref = jda.bwd_reference(jargs[0], jargs[1], jw, jatt, jnp.asarray(gav),
                            m2.reshape(B, OBJS, H) if thresh else None)
    tol = (dict(rtol=1e-2, atol=1e-2) if regime != "f32"
           else dict(rtol=1e-4, atol=1e-5))
    for want in (kern, ref):
        for g, r in zip(bwd, want):
            assert g.dtype == to_torch(gav).dtype
            np.testing.assert_allclose(f32(g), f32(r), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_dvp_matches_jax(rng, dtype):
    T = 3
    dls = rng.standard_normal((T, B, OBJS)).astype(np.float32)
    qps = rng.standard_normal((T, B, H)).astype(np.float32)
    k = rng.standard_normal((1, H)).astype(np.float32)
    if dtype == "bf16":
        dls, qps, k = (x.astype(ml_dtypes.bfloat16) for x in (dls, qps, k))
    masks = da.keep_mask(SEED, range(T), B, OBJS, H, 205)
    out_t = torch.float32 if dtype == "f32" else torch.bfloat16
    got = da.decode_att_dvp_reference(to_torch(dls), to_torch(qps),
                                      to_torch(k), SEED, objs=OBJS,
                                      att_scale=SCALE, thresh=205,
                                      out_dtype=out_t)
    assert got.dtype == out_t and got.shape == (B, OBJS * H)
    assert torch.equal(got, da.decode_att_dvp(
        to_torch(dls), to_torch(qps), to_torch(k), SEED, objs=OBJS,
        att_scale=SCALE, thresh=205, out_dtype=out_t))
    jm = jnp.asarray(masks.numpy())
    out_j = jnp.float32 if dtype == "f32" else jnp.bfloat16
    kern = jda.decode_att_dvp(jnp.asarray(dls), jnp.asarray(qps),
                              jnp.asarray(k), None, objs=OBJS,
                              att_scale=SCALE, thresh=205, out_dtype=out_j,
                              tile_b=4, interpret=True, explicit_masks=jm)
    ref = jda.dvp_reference(jnp.asarray(dls), jnp.asarray(qps), jnp.asarray(k),
                            jm.reshape(T, B, OBJS, H), att_scale=SCALE,
                            out_dtype=out_j)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(f32(got), f32(kern), **tol)
    np.testing.assert_allclose(f32(got).reshape(B, OBJS, H), f32(ref), **tol)


@pytest.mark.parametrize("factored", [True, False])
def test_backward_formulas_match_autograd(rng, factored):
    """decode_att_bwd_reference and a one-step decode_att_dvp_reference (the
    kernels' math) equal torch.autograd of decode_att_fwd_reference with the
    Philox mask held fixed: d_qp, d_vp, d_w."""
    vp, pool, w, qp, k = (to_torch(x) for x in regime_inputs(rng, "f32"))
    vp2 = vp.reshape(B, -1).requires_grad_()
    tq = qp.requires_grad_()
    tw = w.requires_grad_() if factored else None
    att, att_v = da.decode_att_fwd_reference(vp2, pool.reshape(B, -1), tw, tq,
                                             k, SEED, STEP, objs=OBJS,
                                             att_scale=SCALE, thresh=205)
    gav = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    inputs = [vp2, tq] + ([tw] if factored else [])
    auto = torch.autograd.grad(att_v, inputs, gav)
    d_qp_pre, m, dl = da.decode_att_bwd_reference(
        vp2.detach(), pool.reshape(B, -1), None if tw is None else tw.detach(),
        att.detach(), gav, SEED, STEP, objs=OBJS, thresh=205)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f32(d_qp_pre * SCALE * k[0]), f32(auto[1]), **tol)
    d_vp = da.decode_att_dvp_reference(dl[None], tq.detach()[None], k, SEED,
                                       objs=OBJS, att_scale=SCALE, thresh=205,
                                       out_dtype=torch.float32)
    # the one step is t = 0 in dvp's numbering: compare at STEP = 0 masks
    d_vp0 = da.decode_att_dvp_reference(
        dl[None], tq.detach()[None], k, SEED, objs=OBJS, att_scale=SCALE,
        thresh=205, out_dtype=torch.float32,
        masks=da.keep_mask(SEED, [STEP], B, OBJS, H, 205))
    np.testing.assert_allclose(f32(d_vp0), f32(auto[0]), **tol)
    assert not torch.allclose(d_vp, d_vp0)      # another step, another mask
    if factored:
        np.testing.assert_allclose(f32(att.detach() * m), f32(auto[2]), **tol)
    # softmax cotangents sum to zero: the bias gradient outside the kernel
    np.testing.assert_allclose(f32(dl.sum(1)), np.zeros(B), atol=1e-5)
