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

import jax
import jax.numpy as jnp

from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.ops.pallas import decode_att as jda
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops.kernels import _build
from vqa_tpu_torch.ops.kernels import decode_att as da
from vqa_tpu_torch.tools.convert import flax_to_state_dict

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


@pytest.mark.parametrize("hidden", [20, 24])
def test_keep_mask_of_any_width(hidden):
    """At an H that is not a multiple of 16 the mask draws the lane groups
    of the next multiple (32) with the same keys and counters, and keeps
    each box's first H lanes; its keep rate is thresh / 256 within 4 sigma
    (as test_keep_mask_rate)."""
    for t in (STEP, [0, STEP, 9]):
        for stream in (0, 2):
            got = da.keep_mask(SEED, t, 37, OBJS, hidden, 205, stream=stream,
                               row0=3)
            full = da.keep_mask(SEED, t, 37, OBJS, 32, 205, stream=stream,
                                row0=3)
            lead = full.shape[:-1]
            want = full.reshape(*lead, OBJS, 32)[..., :hidden]
            assert torch.equal(got, want.reshape(*lead, OBJS * hidden))
    mask = da.keep_mask(SEED, range(20), 64, 36, hidden, 205)
    p, n = 205 / 256, mask.numel()
    assert abs(mask.double().mean().item() - p) < 4 * math.sqrt(p * (1 - p) / n)


def _butd_twins(hidden, dropout, att_dropout):
    """vqa_tpu's and the port's caption model (base encoder, BUTD decoder of
    width ``hidden``, no VQA head) with the same weights; the port's with
    ``use_pallas`` (here the wrappers' plain versions)."""
    dims = dict(encoder_type="base", predictor_type="none",
                decoder_type="butd", ntoken=30, v_dim=16, embed_dim=8,
                hidden_dim=16, decoder_hidden_dim=hidden, ans_dim=4, c_len=7,
                dropout=dropout, att_dropout=att_dropout, att_type="new")
    rng = np.random.default_rng(7)
    batch = {"q": rng.integers(0, 30, (4, 5)).astype(np.int32),
             "img": rng.standard_normal((4, OBJS, 16)).astype(np.float32),
             "c": rng.integers(0, 29, (4, 7)).astype(np.int32),
             "cap_len": np.array([7, 3, 5, 2], np.int32)}
    jm = jax_set_model(**dims)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init(jax.random.key(0), jb, method="get_loss")["params"]
    port = set_model(**dims, use_pallas=True, device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, jb, port.train(), {k: torch.from_numpy(v)
                                          for k, v in batch.items()}


@pytest.mark.parametrize("hidden", [20, 24])
def test_butd_caption_loss_at_any_hidden_width(hidden):
    """The BUTD caption loss in training at a decoder width that is not a
    multiple of 16 (the scan takes the plain tail there): with dropout 0.5
    / 0.2 the loss and every gradient are finite; at p=0 the loss and the
    decoder's gradients equal vqa_tpu's (its fused-VJP scan)."""
    _, _, _, port, tb = _butd_twins(hidden, 0.5, 0.2)
    loss, _ = port.get_loss(tb, seed=SEED)
    loss.backward()
    assert math.isfinite(loss.item())
    for name, prm in port.generator.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), name
    assert torch.isfinite(port.encoder.embedding.weight.grad).all()
    jm, params, jb, port, tb = _butd_twins(hidden, 0.0, 0.0)

    def jloss(p):
        return jm.apply({"params": p}, jb, method="get_loss",
                        deterministic=False, rngs={"dropout": jax.random.key(1)})

    (want, _), w_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    got, _ = port.get_loss(tb, seed=SEED)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-5)
    want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, w_grads))
    for name, prm in port.named_parameters():
        if name.startswith("generator.") and not name.endswith("linear.bias"):
            np.testing.assert_allclose(prm.grad.numpy(), want_g[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


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


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))


def _meta_fwd(batch=4, objs=36, hidden=1024, dim=2048, offset=None):
    """decode_att_fwd's operands on the meta device (bf16 over the int8
    payload, factored weights); ``offset`` = (name, bytes) starts that
    operand's data that many bytes into its storage."""
    def make(name, shape, dtype):
        n = math.prod(shape)
        skip = offset[1] if offset and offset[0] == name else 0
        per = torch.empty((), dtype=dtype).element_size()
        extra = -(-skip // per)
        t = torch.empty(n + extra, device="meta", dtype=dtype)
        if skip:
            t = t.view(torch.int8)[skip:skip + n * per].view(dtype)
        return t[:n].view(*shape)
    bf16 = torch.bfloat16
    return (make("vp2", (batch, objs * hidden), bf16),
            make("pool2", (batch, objs * dim), torch.int8),
            make("w", (batch, objs), bf16), make("qp", (batch, hidden), bf16),
            make("k", (hidden,), bf16))


@pytest.mark.parametrize("case", ["vp2 align", "pool2 align", "qp align",
                                  "H=8208", "D=8208"])
def test_fwd_kernel_refuses_before_any_build(monkeypatch, tmp_path, case):
    """What the streaming forward cannot take raises ValueError before the
    library is built: an operand its bulk copies would read from off a
    16-byte boundary, and H or D above 8192 (a lane's registers)."""
    _no_nvcc(monkeypatch, tmp_path)
    if case.endswith("align"):
        ops, match = _meta_fwd(offset=(case.split()[0], 2)), "16-byte"
    elif case.startswith("H"):
        ops, match = _meta_fwd(hidden=8208), "at most 8192"
    else:
        ops, match = _meta_fwd(dim=8208), "at most 8192"
    objs = ops[2].shape[1]
    with pytest.raises(ValueError, match=match):
        da.decode_att_fwd(*ops, SEED, STEP, objs=objs, att_scale=SCALE,
                          thresh=205, emit_mask=True)


@pytest.mark.parametrize("batch, objs, hidden, dim", [
    (1, 36, 1024, 2048), (4, 64, 1024, 2048), (1003, 36, 1024, 2048),
    (3, 5, 16, 16), (2, 36, 8192, 8192)])
def test_shapes_the_fwd_kernel_takes_reach_the_build(monkeypatch, tmp_path,
                                                     batch, objs, hidden,
                                                     dim):
    """One row, 64 boxes, a ragged B, the smallest widths and the widest
    pass every check of decode_att_fwd and go to the build, which raises
    here (no nvcc) and counts no launch."""
    _no_nvcc(monkeypatch, tmp_path)
    ops = _meta_fwd(batch, objs, hidden, dim)
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        da.decode_att_fwd(*ops, SEED, STEP, objs=objs, att_scale=SCALE,
                          thresh=205, emit_mask=True)
    assert _build.LAUNCHES == before


def _meta_dvp(T=19, batch=4, objs=36, hidden=1024, dtype=torch.bfloat16,
              qps_offset=0):
    """decode_att_dvp's operands on the meta device; ``qps_offset`` starts
    qps's data that many bytes into its storage."""
    n = T * batch * hidden
    per = torch.empty((), dtype=dtype).element_size()
    qps = torch.empty(n + -(-qps_offset // per), device="meta", dtype=dtype)
    if qps_offset:
        qps = qps.view(torch.int8)[qps_offset:qps_offset + n * per].view(dtype)
    return (torch.empty(T, batch, objs, device="meta", dtype=dtype),
            qps[:n].view(T, batch, hidden),
            torch.empty(hidden, device="meta", dtype=dtype))


@pytest.mark.parametrize("case, kw, call_kw, exc, match", [
    ("objs mismatch", dict(objs=36), dict(objs=35), ValueError, "objs=35"),
    ("H=1000", dict(hidden=1000), {}, ValueError, "qps"),
    ("objs=65", dict(objs=65), dict(objs=65), ValueError, "at most 64"),
    ("qps align", dict(qps_offset=8), {}, ValueError, "16-byte"),
    ("float16", dict(dtype=torch.float16), {}, TypeError, "float32 or bfloat16"),
    ("out float16", {}, dict(out_dtype=torch.float16), TypeError, "out_dtype"),
    ("thresh 256", {}, dict(thresh=256), ValueError, "thresh=256"),
])
def test_dvp_kernel_refuses_before_any_build(monkeypatch, tmp_path, case, kw,
                                             call_kw, exc, match):
    """What the deferred reduction cannot take raises before the library is
    built: boxes that do not match dls, an H that is not a whole number of
    16-lane groups, more than 64 boxes, qps off a 16-byte boundary (its
    bulk copies), other types, a thresh outside [1, 255]."""
    _no_nvcc(monkeypatch, tmp_path)
    dls, qps, k = _meta_dvp(**kw)
    args = dict(objs=dls.shape[2], att_scale=SCALE, thresh=205,
                out_dtype=dls.dtype if dls.dtype != torch.float16 else torch.float32)
    args.update(call_kw)
    with pytest.raises(exc, match=match):
        da.decode_att_dvp(dls, qps, k, SEED, **args)


@pytest.mark.parametrize("T, batch, objs, hidden, dtype", [
    (19, 512, 36, 1024, torch.bfloat16), (19, 4096, 36, 1024, torch.bfloat16),
    (19, 1003, 36, 1024, torch.float32), (1, 512, 36, 1024, torch.bfloat16),
    (0, 512, 36, 1024, torch.bfloat16), (19, 512, 64, 1024, torch.bfloat16),
    (19, 512, 36, 1040, torch.bfloat16), (3, 1, 5, 16, torch.float32)])
def test_shapes_the_dvp_kernel_takes_reach_the_build(monkeypatch, tmp_path, T,
                                                     batch, objs, hidden,
                                                     dtype):
    """The training path's B=512, the timed B=4096, a ragged f32 B, one step
    and none, 64 boxes, H=1040 (65 groups) and the smallest widths pass
    every check of decode_att_dvp and go to the build, which raises here
    (no nvcc) and counts no launch."""
    _no_nvcc(monkeypatch, tmp_path)
    dls, qps, k = _meta_dvp(T, batch, objs, hidden, dtype)
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        da.decode_att_dvp(dls, qps, k, SEED, objs=objs, att_scale=SCALE,
                          thresh=205, out_dtype=dtype)
    assert _build.LAUNCHES == before


def test_dvp_bound_counts_the_philox_draws():
    """The deferred reduction's bound (chip_smoke.py) counts its Philox
    draws: at B=4096, 36 boxes, H=1024 and T=19 there are 179,306,496, and
    at 40 instructions a draw over 33.5e9 instructions a ms they take 0.214
    ms, more than its bytes (0.139 ms): the issue of the draws bounds it.
    One step of the forward or backward draws a 19th of them, 0.011 ms,
    below their bytes."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bound", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    draws = da.philox_draws(4096, 36, 1024, 19)
    assert draws == 179_306_496
    dvp_bytes = 2 * (19 * 4096 * (36 + 1024) + 1024 + 4096 * 36 * 1024)
    ms, by, term = smoke.bound(dvp_bytes, 2.0 * 19 * 4096 * 36 * 1024, "f32",
                               draws)
    assert (by, term) == ("operations", "philox issue")
    assert ms == pytest.approx(0.2141, abs=5e-5)
    assert smoke.bound(dvp_bytes, 0, "f32")[0] == pytest.approx(0.139, abs=1e-3)
    step = da.philox_draws(4096, 36, 1024)
    assert step * 19 == draws
    assert step * smoke.PHILOX_INSTRUCTIONS / smoke.ISSUE_PER_MS == \
        pytest.approx(0.0113, abs=1e-4)
