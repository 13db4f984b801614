"""ReGAT training (CONFIGS.md config 5) and GCN-LSTM (the relation encoder
with a BUTD caption decoder) in vqa_tpu_torch against vqa_tpu.

The same weights (the flax init converted by tools/convert.py) and the same
seeded numpy batches with spatial graphs, f32 on the CPU, dropout 0 where
the two are compared (their random streams differ by design): one training
step's loss and every gradient, then a 3-step ``make_train_step``
trajectory (rtol 1e-4, atol 1e-6, as tests/test_torch_cli.py holds config
1's parameters; weights whose gradients are f32 rounding noise are left
out of the parameter comparison, and their gradients checked to be
noise); GCN-LSTM's
``get_loss`` with its gradients and its teacher-forced ``forward_cap``;
and the entry point on config 5's flags over the synthetic root's graph
files.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.training import optim as jax_optim
from vqa_tpu.training.state import TrainState as JaxTrainState
from vqa_tpu.training.state import make_train_step as jax_make_train_step
from vqa_tpu_torch import main as port_main
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.training import checkpoint as ckpt
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import TrainState, make_train_step

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS, C_LEN = 6, 5, 12, 16, 32, 6, 40, 9, 7
TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
OPT = dict(lr=2e-3, max_norm=0.25, warm_up=1, step_size=1, gamma=0.5,
           steps_per_epoch=2)
# the attention linears' biases only shift logits under a softmax: their
# gradients are zero in exact arithmetic and rounding noise in f32
SOFTMAX_BIASES = ("encoder.attention.linear.bias",
                  "generator.attention.linear.bias")
# at this init the correlated conv's DotProduct gets gradients at the f32
# rounding level (|g| ~ 1e-11 in both packages): Adamax turns such noise
# into full-size steps, so after a few steps these weights differ by noise
NOISE_GRADS = ("encoder.spatial_encoder.conv0.dot_product.",)


def dims(decoder_type="none", **over):
    """Config 5 (spatial corr-GCN, one layer, the base VQA head); with a
    decoder, GCN-LSTM with the MTL weighting."""
    return {**dict(encoder_type="relation", predictor_type="base",
                   decoder_type=decoder_type, ntoken=NTOKEN, v_dim=V_DIM,
                   embed_dim=EMBED, hidden_dim=HIDDEN,
                   decoder_hidden_dim=HIDDEN, ans_dim=ANS, c_len=C_LEN,
                   dropout=0.0, att_dropout=0.0, att_type="new",
                   conv_type="corr", conv_layer=1, use_spa=True,
                   use_imp=False, use_mtl=decoder_type != "none"), **over}


def make_batch(rng, feed: str):
    out = {"q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
           "a": (rng.integers(0, 4, (B, ANS)) / 3.0).astype(np.float32),
           "c": rng.integers(0, NTOKEN - 1, (B, C_LEN)).astype(np.int32),
           "cap_len": rng.integers(2, C_LEN + 1, B).astype(np.int32),
           "graph": rng.integers(0, 12, (B, OBJS, OBJS)).astype(np.int32)}
    x = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    if feed == "dense":
        out["img"] = x
    else:
        scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
        out["img_q"] = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
        out["img_scale"] = scale
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def twins(rng, **kw):
    """A vqa_tpu model with its init params and the port's (CPU,
    ``use_pallas``: training runs the float projections and the plain chain
    in both packages) with the same weights."""
    jm = jax_set_model(**dims(**kw))
    params = jm.init(jax.random.key(0), to_jax(make_batch(rng, "dense")),
                     method="get_loss")["params"]
    port = set_model(**dims(**kw), use_pallas=True, device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, port


def check_loss_and_grads(jm, params, port, batch):
    """The port's training-mode get_loss and gradients against
    jax.value_and_grad of vqa_tpu's."""
    jb = to_jax(batch)

    def jloss(p):
        return jm.apply({"params": p}, jb, method="get_loss",
                        deterministic=False, rngs={"dropout": jax.random.key(1)})

    (want, w_writes), w_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    port.train()
    port.zero_grad()
    got, writes = port.get_loss(to_torch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(writes) == set(w_writes)
    for key in writes:
        np.testing.assert_allclose(writes[key].item(), float(w_writes[key]),
                                   **TOL, err_msg=key)
    want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, w_grads))
    got_g = {n: p.grad for n, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        atol = 1e-6 if name in SOFTMAX_BIASES else TOL["atol"]
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"], atol=atol, err_msg=name)
    return writes


@pytest.mark.parametrize("feed", ["dense", "int8"])
def test_regat_step_loss_and_grads_match_jax(rng, feed):
    """One ReGAT training step: the VQA loss and the gradients of every
    parameter, the GCN's included, on both feeds."""
    jm, params, port = twins(rng)
    writes = check_loss_and_grads(jm, params, port, make_batch(rng, feed))
    assert set(writes) == {"train/loss", "train/score"}


def test_regat_trajectory_matches_jax(rng):
    """Three steps of make_train_step (clip, Adamax, StepLR from the second
    epoch of 2 steps) against vqa_tpu's: the loss of each step and the
    final parameters."""
    jm, params, port = twins(rng)
    batches = [make_batch(rng, feed) for feed in ("int8", "dense")]
    tx = jax_optim.make_optimizer(**OPT)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          step=jnp.int32(0), rng=jax.random.key(0))
    jstep = jax_make_train_step(jm, tx)
    want = []
    for i in range(3):
        state, m = jstep(state, to_jax(batches[i % 2]))
        want.append(float(m["loss"]))
    opt = make_optimizer(port, **OPT)
    port_state = TrainState(port, opt, seed=7)
    step = make_train_step(port, opt, compute_dtype=None)
    got = [step(port_state, to_torch(batches[i % 2]))["loss"].item()
           for i in range(3)]
    np.testing.assert_allclose(got, want, **TRAJ_TOL)
    want_p = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       state.params))
    for name, p in port.named_parameters():
        if name in SOFTMAX_BIASES or name.startswith(NOISE_GRADS):
            # noise-driven Adamax updates
            assert p.grad.abs().max().item() < 1e-8, name
            continue
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   **TRAJ_TOL, err_msg=name)


@pytest.mark.parametrize("feed", ["dense", "int8"])
def test_gcn_lstm_get_loss_and_forward_cap_match_jax(rng, feed):
    """GCN-LSTM: get_loss (both heads, MTL weighting, the caption scan over
    the relation encoder's dense ``v``) with every gradient, and the
    teacher-forced forward_cap."""
    jm, params, port = twins(rng, decoder_type="butd")
    batch = make_batch(rng, feed)
    writes = check_loss_and_grads(jm, params, port, batch)
    assert set(writes) == {"train/loss", "train/score", "train/cap/loss"}
    port.eval()
    with torch.no_grad():
        got = port.forward_cap(to_torch(batch))
    want = jm.apply({"params": params}, to_jax(batch), method="forward_cap")
    for key in ("predict", "target", "mask"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL, err_msg=key)


def test_gcn_lstm_bf16_step_with_dropout_and_the_kernels_routes(rng):
    """The shipping recipe on the CPU: bf16 over f32 masters, dropout 0.5 /
    0.2, use_pallas (the wrappers' plain versions here) at a decoder width
    that is not a multiple of 16: finite f32 gradients everywhere."""
    port = set_model(**dims("butd", dropout=0.5, att_dropout=0.2,
                            decoder_hidden_dim=20), use_pallas=True,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(port, lr=2e-3)
    state = TrainState(port, opt, seed=3)
    m = make_train_step(port, opt)(state, to_torch(make_batch(rng, "int8")))
    assert all(torch.isfinite(v).all() for v in m.values())
    for name, p in port.named_parameters():
        assert p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all(), name


def test_cli_config5_train_and_val(tmp_path, monkeypatch):
    """CONFIGS.md config 5 through the port's entry point on the synthetic
    root's graph files: one epoch of training, then --mode val on the best
    model."""
    monkeypatch.chdir(tmp_path)
    root = make_synthetic_root(str(tmp_path), num_images=6, num_questions=16,
                               num_objs=OBJS, v_dim=V_DIM)
    make_synthetic_root(str(tmp_path), split="val2014", num_images=4,
                        num_questions=8, num_objs=OBJS, v_dim=V_DIM, seed=9)
    argv = ["--vocab_path", root["vocab_path"], "--ans_path", root["ans_path"],
            "--load_path", root["annot"], "--feature_path",
            root["feature_root"], "--graph_path", root["graph_root"],
            "--pretrained_embed_path", "", "--comment", "regat",
            "--encoder_type", "relation", "--conv_type", "corr",
            "--conv_layer", "1", "--predictor_type", "base",
            "--decoder_type", "none", "--select_path", "vqa",
            "--embed_dim", "12", "--hidden_dim", "16",
            "--v_dim", str(V_DIM), "--batch_size", "8", "--epoches", "1",
            "--device", "cpu"]
    port_main.main(argv + ["--mode", "train"])
    out = tmp_path / "checkpoint" / "regat"
    saved = ckpt.load_checkpoint(str(out / "epoch_0.ckpt"))
    assert saved["step"] == 2
    assert any(k.startswith("encoder.spatial_encoder.conv0.")
               for k in saved["model"])
    assert len(np.load(out / "valid" / "scores.npy")) == 8
    os.remove(out / "valid" / "scores.npy")
    port_main.main(argv + ["--mode", "val"])
    scores = np.load(out / "valid" / "scores.npy")
    assert scores.shape == (8,) and np.isfinite(scores).all()
