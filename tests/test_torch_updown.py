"""The port's Up-Down VQA slice end to end against vqa_tpu.

``VQAModel.forward``, ``forward_vqa`` and ``get_att`` of vqa_tpu_torch and of
vqa_tpu, with the same weights (converted from the flax init) and the same
seeded numpy batches, on the CPU.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.wrapper import (
    compute_score as jax_compute_score,
    instance_bce_with_logits as jax_bce,
    set_model as jax_set_model,
)
from vqa_tpu_torch.models.wrapper import (
    compute_score, instance_bce_with_logits, set_model,
)
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS = 16, 6, 12, 32, 128, 6, 50, 20
DIMS = dict(encoder_type="base", predictor_type="base", decoder_type="none",
            ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
            ans_dim=ANS, dropout=0.2, att_type="new")
TOL = dict(rtol=1e-4, atol=1e-5)


def batches(rng, feed: str):
    """(jax batch, torch batch) with the same values."""
    out = {"q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
           "a": (rng.random((B, ANS)) < 0.2).astype(np.float32)}
    if feed == "dense":
        out["img"] = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    else:
        x = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
        scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8)
        out["img_q"] = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
        # the production feed's bf16 scales (bench.py fast config)
        out["img_scale"] = scale.astype(ml_dtypes.bfloat16).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in out.items()}
    tb = {k: torch.from_numpy(v) for k, v in out.items()}
    if feed == "int8":
        jb["img_scale"] = jb["img_scale"].astype(jnp.bfloat16)
        tb["img_scale"] = tb["img_scale"].to(torch.bfloat16)
    return jb, tb


def twins(rng, use_pallas: bool, bf16: bool):
    """A vqa_tpu model with its init params and the port model with the same
    weights; bf16 casts both sides' params (f32 -> bf16 rounds alike)."""
    jm = jax_set_model(**DIMS, use_pallas=use_pallas)
    jb, _ = batches(rng, "dense")
    params = jm.init(jax.random.key(0), jb)["params"]
    port = set_model(**DIMS, use_pallas=use_pallas, device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    if bf16:
        params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
        port = port.to(torch.bfloat16)
    return jm, params, port.eval()


def test_updown_f32_dense_matches_jax(rng):
    jm, params, port = twins(rng, use_pallas=False, bf16=False)
    jb, tb = batches(rng, "dense")
    with torch.no_grad():
        got, caption = port(tb)
        score, label, target = port.forward_vqa(tb)
        att_pred, v_att = port.get_att(tb)
    want, _ = jm.apply({"params": params}, jb)
    assert caption is None and got.shape == (B, ANS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w_score, w_label, w_target = jm.apply({"params": params}, jb,
                                          method=jm.forward_vqa)
    np.testing.assert_array_equal(label.numpy(), np.asarray(w_label))
    np.testing.assert_allclose(score.numpy(), np.asarray(w_score), **TOL)
    np.testing.assert_array_equal(target.numpy(), np.asarray(w_target))
    w_pred, w_att = jm.apply({"params": params}, jb, method=jm.get_att)
    np.testing.assert_allclose(att_pred.numpy(), np.asarray(w_pred), **TOL)
    np.testing.assert_allclose(v_att.numpy(), np.asarray(w_att), **TOL)


def test_updown_bf16_int8_feed_kernels_match_jax(rng):
    """The production form: bf16 params, int8 feed, use_pallas on both sides
    (JAX runs gru_v2 in interpret mode; the port's wrappers run their plain
    versions on the CPU). The two round to bf16 at different points: XLA
    keeps fused elementwise chains in f32 where PyTorch rounds each op, and
    the kernel GRU's f32 state is rounded once at the end. Through ~6 bf16
    layers that is a few bf16 ulps (2**-8 relative each) of the largest
    logit (measured: 0.3-0.7%), so the bound is 2% of max |logit|, with
    argmax agreement >= 90% (near-ties after the classifier's ReLU can
    flip)."""
    jm, params, port = twins(rng, use_pallas=True, bf16=True)
    jb, tb = batches(rng, "int8")
    with torch.no_grad():
        got, _ = port(tb)
        _, label, _ = port.forward_vqa(tb)
    want, _ = jm.apply({"params": params}, jb)
    _, w_label, _ = jm.apply({"params": params}, jb, method=jm.forward_vqa)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == (B, ANS) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    assert (label.numpy() == np.asarray(w_label)).mean() >= 0.9


def test_updown_f32_int8_feed_matches_jax(rng):
    """The int8 feed in f32 (plain path, lazy pooling) at the f32 tolerance."""
    jm, params, port = twins(rng, use_pallas=False, bf16=False)
    jb, tb = batches(rng, "int8")
    jb["img_scale"] = jb["img_scale"].astype(jnp.float32)
    tb["img_scale"] = tb["img_scale"].float()
    with torch.no_grad():
        got, _ = port(tb)
    want, _ = jm.apply({"params": params}, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_compute_score_and_bce_match_jax(rng):
    predict = rng.standard_normal((B, ANS)).astype(np.float32)
    target = (rng.random((B, ANS)) * (rng.random((B, ANS)) < 0.3)).astype(np.float32)
    score, label = compute_score(torch.from_numpy(predict),
                                 torch.from_numpy(target), get_label=True)
    w_score, w_label = jax_compute_score(jnp.asarray(predict),
                                         jnp.asarray(target), get_label=True)
    np.testing.assert_array_equal(label.numpy(), np.asarray(w_label))
    np.testing.assert_array_equal(score.numpy(), np.asarray(w_score))
    loss = instance_bce_with_logits(torch.from_numpy(predict).to(torch.bfloat16),
                                    torch.from_numpy(target))
    want = jax_bce(jnp.asarray(predict, jnp.bfloat16), jnp.asarray(target))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("override", [
    {"encoder_type": "relation", "decoder_type": "butd"},
    {"encoder_type": "cap"},
    {"predictor_type": "base-cap"}, {"predictor_type": "q-cap"},
    {"frozen_embedding": np.zeros((NTOKEN + 4, EMBED), np.float32)},
    {"encoder_type": "relation", "decoder_type": "base"},
])
def test_set_model_rejects_what_the_slice_does_not_hold(override):
    """Every configuration the Up-Down slice refused now builds: the
    relation encoder with a caption decoder (GCN-LSTM), the caption encoder,
    the base-cap head, a frozen GloVe table and the Q-Relevant head (q-cap)
    over a base encoder that forms the dense ``v`` and no pooled ``v_sum``
    (tests/test_torch_regat_train.py, tests/test_torch_caption_heads.py and
    tests/test_torch_qrel.py hold them against vqa_tpu)."""
    model = set_model(**{**DIMS, "decoder_hidden_dim": HIDDEN, **override},
                      device="cpu")
    want = {"relation": "RelationEncoder", "cap": "CaptionEncoder"}
    assert type(model.encoder).__name__ == want.get(
        override.get("encoder_type"), "BaseEncoder")
    heads = {"base-cap": "BaseCaptionPredictor",
             "q-cap": "PredictorwithCaption"}
    assert type(model.predictor).__name__ == heads.get(
        override.get("predictor_type"), "BasePredictor")
    if override.get("predictor_type") == "q-cap":
        assert model.encoder.with_v and not model.encoder.with_v_sum
    assert (model.generator is None) == ("decoder_type" not in override)
    frozen = "frozen_embedding" in override
    assert (model.encoder.embedding.weight is None) == frozen
    assert any("embedding" in n for n in model.state_dict()) != frozen
