"""The port's custom-backward decode scan (vqa_tpu_torch/ops/decode_scan.py).

- Without dropout, ``scan_fn`` against vqa_tpu's ``make_butd_caption_scan``
  (dense and factored int8 input): the features and the gradients of every
  input, with the parameters converted by vqa_tpu_torch/tools/convert.py.
- With dropout on (the attention through the decode-attention wrappers,
  whose CPU path is their plain versions, or through the plain versions
  directly), ``scan_fn``'s hand-written backward against torch.autograd of
  the port's own ``reference_fn`` under the same Philox masks: the
  counterpart of tests/test_models.py
  test_fused_vjp_gradients_match_autodiff_with_dropout.
- The factored scan against the dense scan over ``v = w * q8``.
f32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.ops.decode_scan import make_butd_caption_scan as jax_make_scan
from vqa_tpu_torch.ops.decode_scan import (
    SCAN_PARAMS, STREAM_H2, make_butd_caption_scan)
from vqa_tpu_torch.ops.kernels import decode_att as da
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, NOBJ, VDIM, E, H, T = 4, 7, 24, 10, 16, 6
SEED = 987654321


def jax_params(rng):
    """A vqa_tpu scan parameter tree (tests/test_models.py's layout)."""
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return {
        "word_rnn": {"wi": f(H + VDIM + E, 3 * H), "bi": f(3 * H),
                     "wh": f(H, 3 * H), "bh": f(3 * H)},
        "language_rnn": {"wi": f(VDIM + H, 3 * H), "bi": f(3 * H),
                         "wh": f(H, 3 * H), "bh": f(3 * H)},
        "h1_fcnet": {"w": f(H, H), "b": f(H)},
        "attention": {"W_q": {"fc0": {"v": f(H, H), "g": np.float32(1.3),
                                      "b": f(H)}},
                      "linear": {"v": f(H, 1), "g": np.float32(0.8),
                                 "b": f(1)}},
    }


def port_params(tree):
    """The same parameters under the decoder's state_dict names."""
    sd = flax_to_state_dict({"g": tree})
    P = {k[2:]: v for k, v in sd.items()}
    assert set(P) == set(SCAN_PARAMS)
    return P


def inputs(rng, factored: bool):
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    if factored:
        vis = [rng.integers(-127, 128, (B, NOBJ, VDIM)).astype(np.int8),
               (rng.random((B, NOBJ)) * 0.05 + 0.01).astype(np.float32)]
    else:
        vis = [f(B, NOBJ, VDIM)]
    return vis + [f(B, NOBJ, H), f(B, 3 * H), f(B, T, E), f(B, H), f(B, H)]


def port_grads(fn, P, args, co):
    """(features, grads of the params by name, grads of the float args)."""
    leaves = {n: p.clone().requires_grad_() for n, p in P.items()}
    targs = [torch.from_numpy(a) for a in args]
    targs = [a.requires_grad_() if a.is_floating_point() else a for a in targs]
    out = fn(leaves, *targs, SEED)
    floats = [a for a in targs if a.requires_grad]
    g = torch.autograd.grad((out * torch.from_numpy(co)).sum(),
                            list(leaves.values()) + floats)
    return out, dict(zip(leaves, g[:len(leaves)])), g[len(leaves):]


@pytest.mark.parametrize("pallas_att", [True, False])
@pytest.mark.parametrize("factored", [False, True])
def test_scan_matches_jax_without_dropout(rng, factored, pallas_att):
    tree = jax_params(rng)
    args = inputs(rng, factored)
    co = (rng.standard_normal((T, B, H)) * 0.3).astype(np.float32)
    kw = dict(hidden_dim=H, v_dim=VDIM, dropout=0.4, att_dropout=0.25,
              deterministic=True, factored_v=factored)
    jscan, _ = jax_make_scan(**kw)
    scan, _ = make_butd_caption_scan(**kw, pallas_att=pallas_att)
    key = jax.random.key(0)
    jargs = [jnp.asarray(a) for a in args]
    float_idx = [i for i, a in enumerate(args) if a.dtype == np.float32]
    want_out = jscan(jax.tree_util.tree_map(jnp.asarray, tree), *jargs, key)

    def jloss(P, *fl):
        full = list(jargs)
        for i, x in zip(float_idx, fl):
            full[i] = x
        return jnp.sum(jscan(P, *full, key) * co)

    jg = jax.grad(jloss, argnums=tuple(range(1 + len(float_idx))))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        *[jargs[i] for i in float_idx])
    out, gP, gx = port_grads(scan, port_params(tree), args, co)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **tol)
    want_P = port_params(jax.tree_util.tree_map(np.asarray, jg[0]))
    for name in SCAN_PARAMS:
        np.testing.assert_allclose(gP[name].numpy(), want_P[name].numpy(),
                                   err_msg=name, **tol)
    for got, want in zip(gx, jg[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("pallas_att", [True, False])
@pytest.mark.parametrize("factored", [False, True])
def test_scan_backward_matches_autograd_with_dropout(rng, factored,
                                                     pallas_att):
    """Dropout 0.4 on h1 and h2, 0.25 on the attention joint, one seed: the
    hand-written backward equals autograd of reference_fn for every input,
    and the features equal reference_fn's."""
    P = port_params(jax_params(rng))
    args = inputs(rng, factored)
    co = (rng.standard_normal((T, B, H)) * 0.3).astype(np.float32)
    scan, ref = make_butd_caption_scan(
        hidden_dim=H, v_dim=VDIM, dropout=0.4, att_dropout=0.25,
        deterministic=False, factored_v=factored, pallas_att=pallas_att)
    out, gP, gx = port_grads(scan, P, args, co)
    r_out, r_gP, r_gx = port_grads(ref, P, args, co)
    np.testing.assert_allclose(out.detach().numpy(), r_out.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    # the int8 payload makes the factored gradients ~100x larger
    tol = dict(rtol=5e-5, atol=2e-6 if not factored else 5e-5)
    for name in SCAN_PARAMS:
        np.testing.assert_allclose(gP[name].numpy(), r_gP[name].numpy(),
                                   err_msg=name, **tol)
    for a, b in zip(gx, r_gx):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    # the features are zero exactly where the h2 mask drops (stream 2)
    keep2 = da.keep_mask(SEED, range(T), B, 1, H, 154, stream=STREAM_H2)
    assert torch.equal(out.detach() == 0, keep2 == 0)


@pytest.mark.parametrize("deterministic", [True, False])
def test_factored_scan_matches_dense(rng, deterministic):
    """The scan over (q8, w) equals the scan over v = w * q8: features and
    the gradients of the params, w (through v) and the other inputs."""
    P = port_params(jax_params(rng))
    q8, w, *rest = inputs(rng, factored=True)
    co = (rng.standard_normal((T, B, H)) * 0.3).astype(np.float32)
    kw = dict(hidden_dim=H, v_dim=VDIM, dropout=0.4, att_dropout=0.25,
              deterministic=deterministic, pallas_att=True)
    fac, _ = make_butd_caption_scan(factored_v=True, **kw)
    dense, _ = make_butd_caption_scan(**kw)
    out, gP, gx = port_grads(fac, P, [q8, w] + rest, co)

    def dense_of(P_, w_, *r, seed):
        v = w_[:, :, None] * torch.from_numpy(q8).float()
        return dense(P_, v, *r, seed)

    d_out, d_gP, d_gx = port_grads(lambda P_, *a: dense_of(P_, *a[:-1],
                                                           seed=a[-1]),
                                   P, [w] + rest, co)
    np.testing.assert_allclose(out.detach().numpy(), d_out.detach().numpy(),
                               rtol=2e-5, atol=2e-6)
    for name in SCAN_PARAMS:
        np.testing.assert_allclose(gP[name].numpy(), d_gP[name].numpy(),
                                   rtol=1e-4, atol=5e-6, err_msg=name)
    for a, b in zip(gx, d_gx):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=5e-6)
