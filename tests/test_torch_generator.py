"""The port's caption-decoder modules against vqa_tpu's.

Cells, beam-mode attention, the decoders' steps and the teacher-forced
caption forward of vqa_tpu_torch and of vqa_tpu, with the same weights (the
flax init, converted by vqa_tpu_torch/tools/convert.py) and the same seeded
numpy inputs, f32 on the CPU at the tolerance of tests/test_full_parity.py
(rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.generator import set_decoder as jax_set_decoder
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.ops import attention as jax_attention
from vqa_tpu.ops.rnn import RNNCellBase
from vqa_tpu_torch.models.generator import set_decoder
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops.attention import ConcatAttention, MultiplyAttention
from vqa_tpu_torch.ops.rnn import RNNCell
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, K, OBJS, V_DIM, EMBED, HIDDEN, NTOKEN, C_LEN = 4, 3, 5, 24, 10, 16, 40, 6
TOL = dict(rtol=1e-4, atol=1e-5)


def load(port: torch.nn.Module, params, scope: str = "m") -> torch.nn.Module:
    """Load flax ``params`` of one module into ``port`` (strict), converted
    as they would be inside a model under the module name ``scope``."""
    sd = flax_to_state_dict({scope: jax.tree_util.tree_map(np.asarray, params)})
    port.load_state_dict({k[len(scope) + 1:]: v for k, v in sd.items()})
    return port.eval()


def close(got, want) -> None:
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def f32(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_rnn_cell_matches_jax(rng, rnn_type):
    x = f32(rng, B, EMBED)
    h = f32(rng, B, HIDDEN) * 0.5
    carry = h if rnn_type == "GRU" else (h, f32(rng, B, HIDDEN) * 0.5)
    jm = RNNCellBase(HIDDEN, rnn_type)
    params = jm.init(jax.random.key(0), carry, jnp.asarray(x))["params"]
    port = load(RNNCell(EMBED, HIDDEN, rnn_type), params)
    assert port.weight_ih.shape == ((3 if rnn_type == "GRU" else 4) * HIDDEN, EMBED)
    t_carry = torch.from_numpy(h) if rnn_type == "GRU" else \
        tuple(torch.from_numpy(c) for c in carry)
    close(port(t_carry, torch.from_numpy(x)),
          jm.apply({"params": params}, carry, jnp.asarray(x)))


@pytest.mark.parametrize("att_type", ["new", "base"])
def test_attention_project_v_and_beam_mode_match_jax(rng, att_type):
    """project_v, the 2-D question against the projection as ``v_cache``,
    and beam mode: q [B, k, H] against v shared by the k beams, softmax over
    the boxes (axis 2)."""
    v = f32(rng, B, OBJS, V_DIM)
    q = f32(rng, B, HIDDEN)
    qk = f32(rng, B, K, HIDDEN)
    if att_type == "new":
        jm = jax_attention.MultiplyAttention(HIDDEN)
        port_cls, scope = MultiplyAttention, "m"
    else:
        jm = jax_attention.ConcatAttention(HIDDEN)
        port_cls, scope = ConcatAttention, "attention"
    params = jm.init(jax.random.key(1), jnp.asarray(v), jnp.asarray(q))["params"]
    port = load(port_cls(V_DIM, HIDDEN, HIDDEN), params, scope=scope)
    apply = lambda *a, **kw: jm.apply({"params": params}, *a, **kw)
    vp = apply(jnp.asarray(v), HIDDEN, method=jm.project_v)
    t_vp = port.project_v(torch.from_numpy(v))
    close(t_vp, vp)
    got_2d = port(None, torch.from_numpy(q), v_cache=t_vp)
    assert got_2d.shape == (B, OBJS, 1)
    close(got_2d, apply(jnp.asarray(v), jnp.asarray(q), v_cache=vp))
    got_beam = port(torch.from_numpy(v), torch.from_numpy(qk))
    assert got_beam.shape == (B, K, OBJS, 1)
    close(got_beam, apply(jnp.asarray(v), jnp.asarray(qk)))
    close(got_beam.sum(dim=2), np.ones((B, K, 1), np.float32))


def decoder_twins(decoder_type: str, att_type: str, rnn_type: str):
    """A vqa_tpu decoder with its init params and the port decoder with the
    same weights."""
    rng = np.random.default_rng(3)
    jd = jax_set_decoder(decoder_type, ntoken=NTOKEN, hidden_dim=HIDDEN,
                         max_len=C_LEN, dropout=0.3, rnn_type=rnn_type,
                         att_type=att_type)
    init_batch = {"v": jnp.asarray(f32(rng, 2, OBJS, V_DIM)),
                  "c": jnp.asarray(f32(rng, 2, C_LEN, EMBED)),
                  "cap_len": jnp.full((2,), C_LEN, jnp.int32),
                  "c_target": jnp.zeros((2, C_LEN), jnp.int32)}
    params = jd.init(jax.random.key(2), init_batch)["params"]
    port = set_decoder(decoder_type, NTOKEN, HIDDEN, C_LEN, dropout=0.3,
                       rnn_type=rnn_type, att_type=att_type, v_dim=V_DIM,
                       embed_dim=EMBED)
    return jd, params, load(port, params, scope="generator")


@pytest.mark.parametrize("decoder_type,att_type,rnn_type", [
    ("butd", "new", "GRU"), ("base", "base", "GRU"), ("butd", "base", "LSTM"),
    ("base", "new", "LSTM")])
@pytest.mark.parametrize("beam", [1, K])
@pytest.mark.parametrize("return_features", [False, True])
def test_decoder_step_matches_jax(rng, decoder_type, att_type, rnn_type,
                                  beam, return_features):
    """One decode step from a non-zero state: the new state, the logits (or
    the vocab head's input features) and the attention. ``beam > 1``: v and
    its projection per image, prev and the state per beam."""
    jd, params, port = decoder_twins(decoder_type, att_type, rnn_type)
    v = f32(rng, B, OBJS, V_DIM)
    rows = B * beam
    v_mean = np.repeat(v.mean(axis=1), beam, axis=0)
    prev = f32(rng, rows, EMBED)

    def state():
        s = f32(rng, rows, HIDDEN) * 0.5
        return (s, f32(rng, rows, HIDDEN) * 0.5) if rnn_type == "LSTM" else s
    h = [state() for _ in range(port.h_num)]
    to_t = lambda s: tuple(map(torch.from_numpy, s)) if isinstance(s, tuple) \
        else torch.from_numpy(s)
    apply = lambda *a, **kw: jd.apply({"params": params}, *a, **kw)
    vp = apply(jnp.asarray(v), method=jd.project_v)
    t_vp = port.project_v(torch.from_numpy(v))
    close(t_vp, vp)
    want = apply(jnp.asarray(v), jnp.asarray(v_mean), jnp.asarray(prev), h,
                 att_cache=vp, beam=beam, return_features=return_features,
                 method=jd.decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(v), torch.from_numpy(v_mean),
                          torch.from_numpy(prev), [to_t(s) for s in h],
                          att_cache=t_vp, beam=beam,
                          return_features=return_features)
    width = HIDDEN if return_features else NTOKEN
    assert got[1].shape == (rows, width) and got[2].shape == (rows, OBJS, 1)
    close(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2])


def test_decoder_init_quirks():
    """BaseDecoder's vocab head starts U(-0.1, 0.1) with a zero bias; BUTD's
    heads keep torch's default Linear init, U(+-1/sqrt(in))."""
    gen = torch.Generator().manual_seed(0)
    base = set_decoder("base", 500, 64, C_LEN, v_dim=V_DIM, embed_dim=EMBED,
                       generator=gen)
    assert base.fcnet.weight.abs().max() <= 0.1
    assert base.fcnet.weight.abs().max() > 0.09
    assert torch.count_nonzero(base.fcnet.bias) == 0
    butd = set_decoder("butd", 500, 64, C_LEN, v_dim=V_DIM, embed_dim=EMBED,
                       generator=gen)
    for head in (butd.h1_fcnet, butd.h2_fcnet):
        assert head.weight.abs().max() <= 64 ** -0.5
        assert head.bias.abs().max() > 0
    assert set_decoder("none", 500, 64, C_LEN, v_dim=V_DIM,
                       embed_dim=EMBED) is None


@pytest.mark.parametrize("decoder_type,att_type,predictor_type,use_mtl", [
    ("butd", "new", "none", False), ("base", "base", "none", False),
    ("butd", "base", "base", True)])
def test_forward_cap_matches_jax(rng, decoder_type, att_type, predictor_type,
                                 use_mtl):
    """The teacher-forced caption forward through the whole model (encoder
    caption inputs, project_v, every step, the validity mask), and with a
    VQA head too: the predictions of VQAModel.forward."""
    dims = dict(encoder_type="base", predictor_type=predictor_type,
                decoder_type=decoder_type, ntoken=NTOKEN, v_dim=V_DIM,
                embed_dim=EMBED, hidden_dim=HIDDEN, decoder_hidden_dim=12,
                ans_dim=7, c_len=C_LEN, dropout=0.2, att_type=att_type,
                use_mtl=use_mtl)
    batch = {"img": f32(rng, B, OBJS, V_DIM),
             "q": rng.integers(0, NTOKEN, (B, 5)).astype(np.int32),
             "c": rng.integers(0, NTOKEN, (B, C_LEN)).astype(np.int32),
             "cap_len": np.array([C_LEN, 3, 1, 5], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_set_model(**dims)
    params = jm.init(jax.random.key(4), jb)["params"]
    port = set_model(**dims, device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    port.eval()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = port.forward_cap(tb)
        predict, caption = port(tb)
    want = jm.apply({"params": params}, jb, method=jm.forward_cap)
    assert set(got) == {"predict", "target", "mask"}
    assert got["predict"].shape == (B, C_LEN - 1, NTOKEN)
    for key in got:
        close(got[key], want[key])
    close(caption["predict"], want["predict"])
    w_predict, _ = jm.apply({"params": params}, jb)
    if predictor_type == "none":
        assert predict is None and w_predict is None
    else:
        close(predict, w_predict)
    assert hasattr(port, "log_vars") == use_mtl
