"""The port's ReGAT serving slice end to end against vqa_tpu.

The relation encoder and the whole relation ``VQAModel`` (spatial corr-GCN,
the base predictor) of vqa_tpu_torch and of vqa_tpu, with the same weights
(the flax init, converted by tools/convert.py) and the same seeded numpy
batches, in f32 on the CPU: both feeds, ``use_pallas`` and ``use_int8`` on
and off. At v_dim = hidden = 128 JAX's own gates admit its Pallas kernels
(int8_matmul_dequant_3d for the v-projection, gcn_chain_fused), which run
in interpret mode; the port's wrappers run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.encoder import set_encoder
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu_torch.models.encoder import RelationEncoder
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS = 16, 6, 12, 128, 128, 6, 50, 20
DIMS = dict(encoder_type="relation", predictor_type="base", decoder_type="none",
            ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
            ans_dim=ANS, dropout=0.2, att_type="new", conv_layer=1,
            conv_type="corr", use_spa=True, use_imp=False)
TOL = dict(rtol=1e-4, atol=1e-5)
# With use_int8 the GCN quantizes its input by rows and the weights per
# column; an f32 rounding difference upstream can flip one quantized value
# by one step where it sits on a midpoint (tests/test_torch_gcn.py
# INT8_ATOL_REL): the bound is 1e-3 of the largest value.
INT8_ATOL_REL = 1e-3


def batches(rng, feed: str, scale_dtype=np.float32):
    """(jax batch, torch batch) with the same values: questions, answers,
    spatial labels 0..11, and dense features or the int8 feed."""
    out = {"q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
           "a": (rng.random((B, ANS)) < 0.2).astype(np.float32),
           "graph": rng.integers(0, 12, (B, OBJS, OBJS)).astype(np.int32)}
    x = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    if feed == "dense":
        out["img"] = x
    else:
        scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8)
        out["img_q"] = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
        out["img_scale"] = scale.astype(scale_dtype)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def twins(rng, **over):
    """A vqa_tpu model with its init params and the port's with the same
    weights (``load_state_dict`` is strict: every GCN key is mapped)."""
    dims = {**DIMS, **over}
    jm = jax_set_model(**dims)
    jb, _ = batches(rng, "dense")
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(0), jb)["params"])
    port = set_model(**dims, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return jm, params, port.eval()


def check(got: torch.Tensor, want, int8: bool) -> None:
    want = np.asarray(want)
    tol = dict(rtol=1e-4, atol=INT8_ATOL_REL * np.abs(want).max()) if int8 else TOL
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


@pytest.mark.parametrize("feed", ["dense", "int8"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("use_int8", [False, True])
def test_relation_model_matches_jax(rng, feed, use_pallas, use_int8):
    """The whole forward, ``forward_vqa`` and ``get_att``."""
    jm, params, port = twins(rng, use_pallas=use_pallas, use_int8=use_int8)
    jb, tb = batches(rng, feed)
    with torch.no_grad():
        got, caption = port(tb)
        score, label, _ = port.forward_vqa(tb)
        att_pred, v_att = port.get_att(tb)
    want, _ = jm.apply({"params": params}, jb)
    assert caption is None and got.shape == (B, ANS)
    check(got, want, use_int8)
    w_score, w_label, _ = jm.apply({"params": params}, jb, method=jm.forward_vqa)
    assert (label.numpy() == np.asarray(w_label)).mean() >= (0.9 if use_int8 else 1.0)
    check(score, w_score, use_int8)
    w_pred, w_att = jm.apply({"params": params}, jb, method=jm.get_att)
    check(att_pred, w_pred, use_int8)
    np.testing.assert_allclose(v_att.numpy(), np.asarray(w_att), **TOL)


@pytest.mark.parametrize("feed", ["dense", "int8"])
@pytest.mark.parametrize("use_imp,conv_layer,use_pallas", [
    (False, 2, True), (True, 1, True), (True, 2, False)])
def test_relation_encoder_matches_jax(rng, feed, use_imp, conv_layer,
                                      use_pallas):
    """The encoder's outputs: the spatial and spatial + implicit branches,
    1 and 2 conv layers. On the int8 feed it returns the GCN's ``v`` and no
    ``v_sum``, ``v_q8`` or ``v_w``."""
    kw = dict(ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
              dropout=0.2, att_type="new", conv_layer=conv_layer,
              conv_type="corr", use_spa=True, use_imp=use_imp,
              use_pallas=use_pallas)
    jm = set_encoder("relation", **kw)
    jb, tb = batches(rng, feed)
    params = jm.init(jax.random.key(6), jb)["params"]
    sd = flax_to_state_dict({"encoder": jax.tree_util.tree_map(np.asarray, params)})
    port = RelationEncoder(NTOKEN, V_DIM, EMBED, HIDDEN, dropout=0.2,
                           att_type="new", use_pallas=use_pallas,
                           conv_layer=conv_layer, use_imp=use_imp)
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port.eval()(tb)
    want = jm.apply({"params": params}, jb)
    assert set(got) == set(want) == {"v", "q", "v_att"}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


@pytest.mark.parametrize("use_imp", [False, True])
def test_relation_encoder_graph_alpha_matches_jax(rng, use_imp):
    """``graph_alpha``: the last branch's correlation per conv layer."""
    jm, params, port = twins(rng, use_pallas=True, use_imp=use_imp,
                             conv_layer=2)
    jb, tb = batches(rng, "int8")
    with torch.no_grad():
        alphas = port.encoder(tb, graph_alpha=True)
    want = jm.apply({"params": params}, jb, True,
                    method=lambda m, b, g: m.encoder(b, graph_alpha=g))
    assert len(alphas) == len(want) == 2
    for a, w in zip(alphas, want):
        assert a.shape == (B, OBJS, OBJS)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_updown_use_int8_matches_jax(rng, use_pallas):
    """The Up-Down base model with ``use_int8`` on the int8 feed: the
    attention v-projection through the int8 GEMM (JAX's 3-D Pallas kernel
    in interpret mode with ``use_pallas``), bias and ReLU in its epilogue,
    and the lazy-v pooling. No GCN, so no input quantization: TOL."""
    jm, params, port = twins(rng, encoder_type="base", use_pallas=use_pallas,
                             use_int8=True)
    jb, tb = batches(rng, "int8")
    with torch.no_grad():
        got, _ = port(tb)
        embed = port.encoder(tb)
    want, _ = jm.apply({"params": params}, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(embed) == {"q", "v_att", "v_q8", "v_w", "v_sum"}


def test_concat_attention_use_int8_matches_jax(rng):
    """ConcatAttention's v-projection as an int8 GEMM (the v rows of its
    concat kernel, no bias), the relation model on the int8 feed."""
    jm, params, port = twins(rng, att_type="base", use_pallas=True,
                             use_int8=True)
    jb, tb = batches(rng, "int8")
    with torch.no_grad():
        got, _ = port(tb)
    want, _ = jm.apply({"params": params}, jb)
    check(got, want, int8=True)


def test_relation_model_bf16_int8_feed_matches_jax(rng):
    """The serving form: bf16 weights, the int8 feed with bf16 scales,
    ``use_pallas`` and ``use_int8`` on both sides. The two round to bf16 at
    different points (XLA keeps fused elementwise chains in f32 where
    PyTorch rounds each op, and the kernel GRU's f32 state is rounded once),
    so a few bf16 ulps (2**-8 each) of the largest logit: 3% of it, as
    tests/test_torch_updown.py allows through fewer layers."""
    jm, params, port = twins(rng, use_pallas=True, use_int8=True)
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    port = port.to(torch.bfloat16)
    jb, tb = batches(rng, "int8")
    jb["img_scale"] = jb["img_scale"].astype(jnp.bfloat16)
    tb["img_scale"] = tb["img_scale"].to(torch.bfloat16)
    with torch.no_grad():
        got, _ = port(tb)
    want, _ = jm.apply({"params": params}, jb)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == (B, ANS) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.03 * np.abs(want).max()


@pytest.mark.parametrize("override", [{"predictor_type": "q-cap"}])
def test_set_model_rejects_what_stays_unported(override):
    """Nothing the relation encoder takes stays unported: the Q-Relevant
    head builds over it too (tests/test_torch_qrel.py holds the head
    against vqa_tpu) and reads the GCN's summed features."""
    model = set_model(**{**DIMS, **override}, device="cpu")
    assert type(model.encoder).__name__ == "RelationEncoder"
    assert type(model.predictor).__name__ == "PredictorwithCaption"
