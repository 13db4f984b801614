"""vqa_tpu params -> vqa_tpu_torch state_dict (vqa_tpu_torch/tools/convert.py).

The port names its parameters as the reference's torch state_dict does, so
vqa_tpu's own importer (vqa_tpu/tools/import_torch.py) maps a port
state_dict back to the flax tree: converting and importing must give back
the tree unchanged, with no unmapped key, and the two models must agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.tools.import_torch import import_reference_state_dict
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.tools.convert import (
    flax_to_state_dict, gcn_params_from_state_dict)

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS = 16, 6, 12, 32, 128, 6, 50, 20


def flat(tree):
    return {tuple(str(p) for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("att_type,cls_layer,rnn_layer", [
    ("new", 2, 1), ("base", 2, 1), ("new", 3, 2)])
def test_convert_round_trips_and_models_agree(rng, att_type, cls_layer,
                                              rnn_layer):
    dims = dict(encoder_type="base", predictor_type="base",
                decoder_type="none", ntoken=NTOKEN, v_dim=V_DIM,
                embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=ANS,
                cls_layer=cls_layer, rnn_layer=rnn_layer, dropout=0.2,
                att_type=att_type)
    img = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    q = rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32)
    jm = jax_set_model(**dims)
    jbatch = {"img": jnp.asarray(img), "q": jnp.asarray(q)}
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(7), jbatch)["params"])

    port = set_model(**dims, generator=torch.Generator().manual_seed(7),
                     device="cpu")
    port.load_state_dict(flax_to_state_dict(params))   # strict: every key
    back, unmapped = import_reference_state_dict(port.state_dict())
    assert unmapped == []
    want, got = flat(params), flat(back)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].reshape(want[key].shape),
                                      want[key], err_msg=str(key))

    with torch.no_grad():
        predict, _ = port.eval()({"img": torch.from_numpy(img),
                                  "q": torch.from_numpy(q)})
    ref, _ = jm.apply({"params": params}, jbatch)
    np.testing.assert_allclose(predict.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("decoder_type,predictor_type,rnn_type,use_mtl", [
    ("butd", "none", "GRU", False), ("base", "none", "LSTM", False),
    ("butd", "base", "GRU", True), ("base", "q-cap", "GRU", True)])
def test_convert_round_trips_caption_models(rng, decoder_type, predictor_type,
                                            rnn_type, use_mtl):
    """Decoder cells (``wi``/``bi``/``wh``/``bh`` with no layer suffix),
    the plain vocab heads ``{w, b}``, the MTL ``log_vars`` and the q-cap
    head (LReLUNets' lone ``w``, the caption embedding's two RNNs); the
    teacher-forced caption forwards agree, and so do the q-cap head's
    predictions."""
    c_len = 5
    dims = dict(encoder_type="base", predictor_type=predictor_type,
                decoder_type=decoder_type, ntoken=NTOKEN, v_dim=V_DIM,
                embed_dim=EMBED, hidden_dim=HIDDEN, decoder_hidden_dim=24,
                ans_dim=ANS, c_len=c_len, rnn_type=rnn_type, dropout=0.2,
                att_type="new", use_mtl=use_mtl)
    batch = {"img": rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32),
             "q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
             "c": rng.integers(0, NTOKEN, (B, c_len)).astype(np.int32),
             "cap_len": rng.integers(1, c_len + 1, B).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_set_model(**dims)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(3), jbatch)["params"])
    if use_mtl:
        params["log_vars"] = np.array([0.25, -0.5], np.float32)

    sd = flax_to_state_dict(params)
    head = "h2_fcnet" if decoder_type == "butd" else "fcnet"
    assert sd[f"generator.{head}.weight"].shape == (NTOKEN, 24)
    cell = "language_rnn" if decoder_type == "butd" else "rnn"
    gates = 3 if rnn_type == "GRU" else 4
    assert sd[f"generator.{cell}.weight_hh"].shape == (gates * 24, 24)
    port = set_model(**dims, device="cpu")
    port.load_state_dict(sd)                          # strict: every key
    back, unmapped = import_reference_state_dict(port.state_dict())
    assert unmapped == []
    want, got = flat(params), flat(back)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].reshape(want[key].shape),
                                      want[key], err_msg=str(key))

    with torch.no_grad():
        cap = port.eval().forward_cap({k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    ref = jm.apply({"params": params}, jbatch, method=jm.forward_cap)
    np.testing.assert_allclose(cap["predict"].numpy(),
                               np.asarray(ref["predict"]), rtol=1e-4,
                               atol=1e-5)
    if predictor_type == "q-cap":
        assert sd["predictor.caption_embedding.attention.W_v.main.0.weight"
                  ].shape == (HIDDEN, HIDDEN)
        assert sd["predictor.v_net.main.0.weight"].shape == (HIDDEN, V_DIM)
        with torch.no_grad():
            predict, _ = port({k: torch.from_numpy(v)
                               for k, v in batch.items()})
        np.testing.assert_allclose(
            predict.numpy(), np.asarray(jm.apply({"params": params},
                                                 jbatch)[0]),
            rtol=1e-4, atol=1e-5)


def test_convert_names_the_reference_keys(rng):
    """Spot-check the reference's torch names (FCNet slots, nested rnn)."""
    jm = jax_set_model(encoder_type="base", predictor_type="base",
                       decoder_type="none", ntoken=NTOKEN, v_dim=V_DIM,
                       embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=ANS,
                       att_type="new")
    batch = {"img": jnp.zeros((2, OBJS, V_DIM)),
             "q": jnp.zeros((2, Q_LEN), jnp.int32)}
    sd = flax_to_state_dict(jm.init(jax.random.key(0), batch)["params"])
    assert sd["encoder.q_rnn.rnn.weight_ih_l0"].shape == (3 * HIDDEN, EMBED)
    assert sd["encoder.embedding.weight"].shape == (NTOKEN + 1, EMBED)
    assert sd["encoder.attention.linear.weight_g"].shape == ()
    assert sd["predictor.classifier.main.3.weight_v"].shape == (ANS, 2 * HIDDEN)
    assert sd["encoder.attention.W_v.main.0.weight_v"].shape == (HIDDEN, V_DIM)


@pytest.mark.parametrize("conv_type,use_imp,conv_layer", [
    ("corr", False, 1), ("corr", True, 2), ("direct", False, 1),
    ("base", True, 1)])
def test_convert_round_trips_gcn_params(rng, conv_type, use_imp, conv_layer):
    """The relation model's GCN convs: flax -> port state_dict (loaded
    strictly) -> flax through the port's own inverse, since vqa_tpu's
    importer maps no GCN key (reference checkpoints carry none); the rest
    round-trips through vqa_tpu's importer. The two models agree."""
    dims = dict(encoder_type="relation", predictor_type="base",
                decoder_type="none", ntoken=NTOKEN, v_dim=V_DIM,
                embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=ANS, dropout=0.2,
                att_type="new", conv_type=conv_type, conv_layer=conv_layer,
                use_spa=True, use_imp=use_imp)
    batch = {"img": rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32),
             "q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
             "graph": rng.integers(0, 12, (B, OBJS, OBJS)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_set_model(**dims)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(9), jbatch)["params"])
    sd = flax_to_state_dict(params)
    conv = "encoder.spatial_encoder.conv0"
    if conv_type == "base":
        assert sd[f"{conv}.weight"].shape == (V_DIM, V_DIM)
        assert f"{conv}.bias" in sd
    else:
        assert sd[f"{conv}.w2.weight"].shape == (V_DIM, V_DIM)
        assert sd[f"{conv}.label_bias"].shape == (12, V_DIM)
        np.testing.assert_array_equal(
            sd[f"{conv}.w0.weight"].numpy(),
            params["encoder"]["spatial_encoder"]["conv0"]["w0"].T)
    if conv_type == "corr":
        assert sd[f"{conv}.dot_product.wb.bias"].shape == (V_DIM,)
    port = set_model(**dims, device="cpu")
    port.load_state_dict(sd)                          # strict: every key
    gcn, rest = gcn_params_from_state_dict(port.state_dict())
    back, unmapped = import_reference_state_dict(rest)
    assert unmapped == []
    for name, tree in gcn["encoder"].items():
        back["encoder"][name] = tree
    want, got = flat(params), flat(back)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].reshape(want[key].shape),
                                      want[key], err_msg=str(key))

    with torch.no_grad():
        predict, _ = port.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    ref, _ = jm.apply({"params": params}, jbatch)
    np.testing.assert_allclose(predict.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_convert_rejects_unknown_parameters():
    with pytest.raises(KeyError, match="encoder.mystery"):
        flax_to_state_dict({"encoder": {"mystery": np.zeros(3)}})
