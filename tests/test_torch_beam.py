"""The port's beam-search caption decoding against vqa_tpu's.

``make_beam_search``, ``tokens_to_captions`` and ``decode_batch`` of
vqa_tpu_torch/tools/beam.py and of vqa_tpu/tools/beam.py, with the same
weights (the flax init, converted by vqa_tpu_torch/tools/convert.py) and the
same seeded numpy batches, f32 on the CPU. The JAX side's ``fused_vocab``
runs its Pallas kernel in interpret mode; the port's runs the kernel's plain
version. Both compute in f32, so the tokens must be equal and the scores
close at rtol 1e-5.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.data.tokenizer import Vocab
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.tools import beam as jax_beam
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops.linear import WNDense
from vqa_tpu_torch.tools import beam
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, Q_LEN, OBJS, V_DIM, EMBED, HIDDEN, NTOKEN, C_LEN = 4, 5, 6, 24, 10, 16, 30, 7
TOL = dict(rtol=1e-5, atol=1e-6)


def vocab() -> Vocab:
    """NTOKEN words, the last four the specials."""
    return Vocab([f"w{i}" for i in range(NTOKEN - 4)] + list(Vocab.SPECIALS))


def batches(rng, feed: str = "dense", scale_dtype=np.float32):
    """(jax batch, torch batch) with the same values."""
    out = {"q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32)}
    x = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    if feed == "dense":
        out["img"] = x
    else:
        scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8)
        out["img_q"] = np.clip(np.rint(x / scale[..., None]), -127,
                               127).astype(np.int8)
        out["img_scale"] = scale.astype(scale_dtype).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in out.items()}
    tb = {k: torch.from_numpy(v) for k, v in out.items()}
    if scale_dtype is ml_dtypes.bfloat16:
        jb["img_scale"] = jb["img_scale"].astype(jnp.bfloat16)
        tb["img_scale"] = tb["img_scale"].to(torch.bfloat16)
    return jb, tb


def twins(decoder_type: str, att_type: str = "new", end_bias: float = 1.0):
    """A vqa_tpu caption model with its init params and the port model with
    the same weights. ``end_bias`` is added to the vocab head's <end> bias
    so that beams finish at different steps and the finished-beam handling
    runs."""
    dims = dict(encoder_type="base", predictor_type="none",
                decoder_type=decoder_type, ntoken=NTOKEN, v_dim=V_DIM,
                embed_dim=EMBED, hidden_dim=HIDDEN, decoder_hidden_dim=12,
                c_len=C_LEN, dropout=0.2, att_type=att_type)
    jm = jax_set_model(**dims)
    jb, _ = batches(np.random.default_rng(0))
    # the decoder's init needs a caption
    jb["c"] = jnp.zeros((B, C_LEN), jnp.int32)
    jb["cap_len"] = jnp.full((B,), C_LEN, jnp.int32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(5), jb)["params"])
    head = "h2_fcnet" if decoder_type == "butd" else "fcnet"
    params["generator"][head]["b"] = params["generator"][head]["b"].copy()
    params["generator"][head]["b"][vocab().end] += end_bias
    port = set_model(**dims, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return jm, params, port.eval()


@pytest.mark.parametrize("decoder_type,att_type", [("butd", "new"),
                                                   ("base", "base")])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("fused_vocab", [False, True])
def test_beam_search_matches_jax(rng, decoder_type, att_type, k, fused_vocab):
    jm, params, port = twins(decoder_type, att_type)
    jb, tb = batches(rng)
    voc = vocab()
    kw = dict(k=k, c_len=C_LEN, start_id=voc.start, end_id=voc.end,
              fused_vocab=fused_vocab)
    w_tokens, w_scores = jax_beam.make_beam_search(jm, **kw)(params, jb)
    tokens, scores = beam.make_beam_search(port, **kw)(tb)
    assert tokens.shape == (B, k, C_LEN) and tokens.dtype == torch.int64
    assert scores.shape == (B, k)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(w_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(w_scores), **TOL)
    assert (tokens[:, :, 0] == voc.start).all()
    if k > 1:
        # beams that finished before the last step, so the test runs the
        # finished-beam path
        assert (tokens[:, :, 1:-1] == voc.end).any()


@pytest.mark.parametrize("decoder_type", ["butd", "base"])
def test_beam_search_legacy_logit_scores_match_jax(rng, decoder_type):
    """The reference's raw-logit scoring, on both vocab-head routes."""
    jm, params, port = twins(decoder_type)
    jb, tb = batches(rng)
    voc = vocab()
    for fused_vocab in (False, True):
        kw = dict(k=3, c_len=C_LEN, start_id=voc.start, end_id=voc.end,
                  legacy_logit_scores=True, fused_vocab=fused_vocab)
        w_tokens, w_scores = jax_beam.make_beam_search(jm, **kw)(params, jb)
        tokens, scores = beam.make_beam_search(port, **kw)(tb)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(w_tokens))
        np.testing.assert_allclose(scores.numpy(), np.asarray(w_scores),
                                   **TOL)


def test_tokens_to_captions_and_decode_batch_match_jax(rng):
    voc = vocab()
    s, e, p = voc.start, voc.end, voc.pad
    rows = np.array([[s, 3, 4, e, 5, e],      # stops at the first <end>
                     [s, e, e, e, e, e],      # empty caption
                     [s, 7, p, 8, 9, 2],      # <pad> dropped, no <end>
                     [e, 1, 2, e, 6, 6]])     # leading <end> is skipped
    for drop in (True, False):
        assert beam.tokens_to_captions(rows, voc, e, drop_specials=drop) \
            == jax_beam.tokens_to_captions(rows, voc, e, drop_specials=drop)
    jm, params, port = twins("butd")
    jb, tb = batches(rng)
    got = beam.decode_batch(port, tb, voc, k=3, c_len=C_LEN)
    assert got == jax_beam.decode_batch(jm, params, jb, voc, k=3,
                                        c_len=C_LEN)
    assert len(got) == B


@pytest.mark.parametrize("att_type", ["new", "base"])
@pytest.mark.parametrize("scale_dtype", [np.float32, ml_dtypes.bfloat16])
def test_int8_feed_v_matches_jax(rng, att_type, scale_dtype):
    """A caption model's encoder on the int8 feed returns ``v`` = v_att *
    (img_q * img_scale), the dequantized features in the scale's dtype, as
    vqa_tpu's does; a VQA-only model does not form it."""
    jm, params, port = twins("butd", att_type)
    jb, tb = batches(rng, "int8", scale_dtype)
    with torch.no_grad():
        got = port.encoder(tb)
    want = jm.apply({"params": params}, jb,
                    method=lambda m, b: m.encoder(b, deterministic=True))
    assert got["v"].dtype == torch.float32
    np.testing.assert_allclose(got["v"].numpy(), np.asarray(want["v"]),
                               rtol=1e-4, atol=1e-5)
    assert "v_sum" not in got     # no predictor reads it
    vqa_only = set_model(encoder_type="base", predictor_type="base",
                         decoder_type="none", ntoken=NTOKEN, v_dim=V_DIM,
                         embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=5,
                         att_type=att_type, device="cpu").eval()
    with torch.no_grad():
        out = vqa_only.encoder(tb)
    assert "v" not in out and "v_sum" in out


def test_fused_vocab_requires_a_plain_head():
    """A vocab head that is not a plain {weight, bias} Linear must not take
    the fused route, as in vqa_tpu."""
    _, _, port = twins("butd")
    port.generator.h2_fcnet = WNDense(12, NTOKEN)
    voc = vocab()
    with pytest.raises(ValueError, match="plain"):
        beam.make_beam_search(port, 3, C_LEN, voc.start, voc.end,
                              fused_vocab=True)
    beam.make_beam_search(port, 3, C_LEN, voc.start, voc.end)
    del port.generator
    port.generator = None
    with pytest.raises(ValueError, match="no caption generator"):
        beam.make_beam_search(port, 3, C_LEN, voc.start, voc.end)
