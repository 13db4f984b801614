"""Module parity: each vqa_tpu_torch module against its vqa_tpu counterpart.

The same seeded numpy inputs and the same weights (the flax init, converted
by vqa_tpu_torch/tools/convert.py) go through both; f32 on the CPU at the
tolerance of tests/test_full_parity.py (rtol 1e-4, atol 1e-5).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.encoder import set_encoder
from vqa_tpu.ops import attention as jax_attention
from vqa_tpu.ops.linear import FCNet as JaxFCNet
from vqa_tpu.ops.rnn import SentenceEmbedding as JaxSentenceEmbedding
from vqa_tpu_torch.models.encoder import BaseEncoder
from vqa_tpu_torch.ops.attention import ConcatAttention, MultiplyAttention
from vqa_tpu_torch.ops.linear import FCNet
from vqa_tpu_torch.ops.rnn import SentenceEmbedding
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN = 16, 6, 12, 32, 128, 6, 50
TOL = dict(rtol=1e-4, atol=1e-5)


def load(port: torch.nn.Module, params, scope: str = "m") -> torch.nn.Module:
    """Load flax ``params`` of one module into ``port`` (strict), converted
    as they would be inside a model under the module name ``scope``."""
    sd = flax_to_state_dict({scope: jax.tree_util.tree_map(np.asarray, params)})
    port.load_state_dict({k[len(scope) + 1:]: v for k, v in sd.items()})
    return port.eval()


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer,mid", [(1, 0), (2, 64), (3, 48)])
def test_fcnet_matches_jax(rng, layer, mid):
    x = rng.standard_normal((B, V_DIM)).astype(np.float32)
    jm = JaxFCNet(20, mid_dim=mid, layer=layer, dropout=0.3)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    port = load(FCNet(V_DIM, 20, mid_dim=mid, layer=layer, dropout=0.3),
                params)
    close(port(torch.from_numpy(x)), jm.apply({"params": params},
                                              jnp.asarray(x)))


def test_fcnet_int8_input_matches_dequantized_jax(rng):
    """An int8 input with per-row scales == the JAX FCNet on the dequantized
    features (the int8 feed's v-projection, plain version on the CPU)."""
    x_q = rng.integers(-127, 128, (B, OBJS, V_DIM)).astype(np.int8)
    scale = (rng.random((B, OBJS)) * 0.03 + 1e-3).astype(np.float32)
    v = x_q.astype(np.float32) * scale[..., None]
    jm = JaxFCNet(HIDDEN)
    params = jm.init(jax.random.key(1), jnp.asarray(v))["params"]
    port = load(FCNet(V_DIM, HIDDEN), params)
    got = port(torch.from_numpy(x_q), x_scale=torch.from_numpy(scale))
    close(got, jm.apply({"params": params}, jnp.asarray(v)))


@pytest.mark.parametrize("rnn_type,rnn_layer,bidirect", [
    ("GRU", 1, False), ("GRU", 2, False), ("LSTM", 1, False),
    ("GRU", 1, True)])
def test_sentence_embedding_matches_jax(rng, rnn_type, rnn_layer, bidirect):
    x = rng.standard_normal((B, Q_LEN, EMBED)).astype(np.float32)
    jm = JaxSentenceEmbedding(HIDDEN, rnn_layer=rnn_layer, rnn_type=rnn_type,
                              bidirect=bidirect)
    params = jm.init(jax.random.key(2), jnp.asarray(x))["params"]
    port = load(SentenceEmbedding(EMBED, HIDDEN, rnn_layer=rnn_layer,
                                  rnn_type=rnn_type, bidirect=bidirect),
                params)
    close(port(torch.from_numpy(x)), jm.apply({"params": params},
                                              jnp.asarray(x)))


def test_multiply_attention_fold_matches_jax(rng):
    """Inference: the folded logits vp @ (qp * w), softmax over the boxes."""
    v = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    q = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    jm = jax_attention.MultiplyAttention(HIDDEN)
    params = jm.init(jax.random.key(3), jnp.asarray(v), jnp.asarray(q))["params"]
    port = load(MultiplyAttention(V_DIM, HIDDEN, HIDDEN), params)
    got = port(torch.from_numpy(v), torch.from_numpy(q))
    assert got.shape == (B, OBJS, 1)
    close(got, jm.apply({"params": params}, jnp.asarray(v), jnp.asarray(q)))


def test_concat_attention_matches_jax(rng):
    v = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    q = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    jm = jax_attention.ConcatAttention(HIDDEN)
    params = jm.init(jax.random.key(4), jnp.asarray(v), jnp.asarray(q))["params"]
    port = load(ConcatAttention(V_DIM, HIDDEN, HIDDEN), params,
                scope="attention")
    close(port(torch.from_numpy(v), torch.from_numpy(q)),
          jm.apply({"params": params}, jnp.asarray(v), jnp.asarray(q)))


@pytest.mark.parametrize("att_type", ["new", "base"])
@pytest.mark.parametrize("feed", ["dense", "int8"])
def test_base_encoder_matches_jax(rng, att_type, feed):
    """Dense feed: v, q, v_att. Int8 feed: the factored outputs v_q8, v_w,
    the pooled v_sum, q and v_att; the port forms no dense v there."""
    q_tok = rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32)
    if feed == "dense":
        img = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
        jbatch = {"img": img, "q": q_tok}
    else:
        jbatch = {"img_q": rng.integers(-127, 128, (B, OBJS, V_DIM)).astype(np.int8),
                  "img_scale": (rng.random((B, OBJS)) * 0.03 + 1e-3).astype(np.float32),
                  "q": q_tok}
    jm = set_encoder("base", ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED,
                     hidden_dim=HIDDEN, dropout=0.2, att_type=att_type)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    params = jm.init(jax.random.key(5), jb)["params"]
    want = jm.apply({"params": params}, jb)
    port = load(BaseEncoder(NTOKEN, V_DIM, EMBED, HIDDEN, dropout=0.2,
                            att_type=att_type), params, scope="encoder")
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in jbatch.items()})
    keys = {"v", "q", "v_att"} if feed == "dense" else \
        {"q", "v_att", "v_q8", "v_w", "v_sum"}
    assert set(got) == keys
    for key in keys:
        close(got[key], want[key])


def test_port_imports_no_jax():
    """vqa_tpu_torch and the slice's modules import neither jax nor flax."""
    code = ("import sys\n"
            "import vqa_tpu_torch.models.wrapper, vqa_tpu_torch.tools.convert\n"
            "import vqa_tpu_torch.ops.kernels._build\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
            "assert not bad, bad\n"
            "assert 'vqa_tpu_torch.ops.kernels.gru_v2' in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr
