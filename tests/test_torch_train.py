"""The port's MTL training step against vqa_tpu's.

The Up-Down MTL model (base encoder, base VQA predictor, BUTD caption
decoder, uncertainty-weighted loss) of vqa_tpu_torch and of vqa_tpu, with
the same weights (the flax init converted by vqa_tpu_torch/tools/convert.py)
and the same seeded numpy batches, f32 on the CPU at the tolerance of
tests/test_full_parity.py (rtol 1e-4, atol 1e-5) unless a test says
otherwise. Dropout is 0 where the two are compared: their random streams
differ by design.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.training import optim as jax_optim
from vqa_tpu.training.state import TrainState as JaxTrainState
from vqa_tpu.training.state import make_train_step as jax_make_train_step
from vqa_tpu_torch.models import wrapper
from vqa_tpu_torch.models.wrapper import ce_for_language_model, set_model
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.training.optim import make_optimizer, steplr_factor
from vqa_tpu_torch.training.state import (
    TrainState, make_eval_step, make_infer_step, make_train_step, step_seeds)

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS, C_LEN = 6, 5, 12, 16, 32, 5, 40, 9, 7
TOL = dict(rtol=1e-4, atol=1e-5)
OPT = dict(lr=2e-3, lr_vqa=4e-3, lr_cap=3e-3, max_norm=0.25, warm_up=1,
           step_size=1, gamma=0.5, steps_per_epoch=2)


def dims(dropout=0.0, att_dropout=0.0, decoder_type="butd", att_type="new",
         rnn_type="GRU"):
    return dict(encoder_type="base", predictor_type="base",
                decoder_type=decoder_type, ntoken=NTOKEN, v_dim=V_DIM,
                embed_dim=EMBED, hidden_dim=HIDDEN, decoder_hidden_dim=HIDDEN,
                ans_dim=ANS, c_len=C_LEN, dropout=dropout,
                att_dropout=att_dropout, att_type=att_type, rnn_type=rnn_type,
                use_mtl=True)


def make_batch(rng, feed: str, c_len: int = C_LEN):
    """A numpy batch: questions, soft answers, captions and the dense or
    int8 feed (f32 scales)."""
    out = {"q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
           "a": (rng.integers(0, 4, (B, ANS)) / 3.0).astype(np.float32),
           "c": rng.integers(0, NTOKEN - 1, (B, c_len)).astype(np.int32),
           "cap_len": rng.integers(2, c_len + 1, B).astype(np.int32)}
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
    """A vqa_tpu MTL model with its init params and the port model (CPU)
    with the same weights."""
    jm = jax_set_model(**dims(**kw))
    params = jm.init(jax.random.key(0), to_jax(make_batch(rng, "dense")),
                     method="get_loss")["params"]
    port = set_model(**dims(**kw), use_pallas=True, device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, port


def grads_of(port):
    return {n: p.grad for n, p in port.named_parameters()}


# the attention linears' biases only shift logits under a softmax: their
# gradients are zero in exact arithmetic and rounding noise in f32
SOFTMAX_BIASES = ("encoder.attention.linear.bias",
                  "generator.attention.linear.bias")


def test_vqa_head_alone_on_the_int8_feed_matches_jax(rng):
    """A VQA head without a decoder on the int8 feed (bench_train's
    vqa-int8 rows): the encoder forms no dense ``v``, only the pooled
    ``v_sum``."""
    jm, params, port = twins(rng, decoder_type="none")
    batch = {k: v for k, v in make_batch(rng, "int8").items() if k not in ("c", "cap_len")}
    (want, w_writes), w_grads = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, to_jax(batch), method="get_loss",
                           deterministic=True), has_aux=True)(params)
    port.train()
    got, writes = port.get_loss(to_torch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(writes) == set(w_writes) == {"train/loss", "train/score"}
    want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, w_grads))
    for name, g in grads_of(port).items():
        atol = 1e-6 if name in SOFTMAX_BIASES else TOL["atol"]
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"], atol=atol, err_msg=name)


@pytest.mark.parametrize("feed", ["dense", "int8"])
def test_get_loss_and_grads_match_jax(rng, feed):
    """get_loss (MTL weighting, both heads, the fused caption scan through
    the decode-attention wrappers' plain versions) and every gradient,
    log_vars included, against jax.value_and_grad of vqa_tpu's get_loss."""
    jm, params, port = twins(rng)
    batch = make_batch(rng, feed)
    jb = to_jax(batch)

    def jloss(p):
        return jm.apply({"params": p}, jb, method="get_loss",
                        deterministic=False, rngs={"dropout": jax.random.key(1)})

    (want, w_writes), w_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    port.train()
    got, writes = port.get_loss(to_torch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(writes) == set(w_writes) == {"train/loss", "train/score",
                                             "train/cap/loss"}
    for key in writes:
        np.testing.assert_allclose(writes[key].item(), float(w_writes[key]),
                                   **TOL)
    want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, w_grads))
    got_g = grads_of(port)
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        atol = 1e-6 if name in SOFTMAX_BIASES else TOL["atol"]
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"], atol=atol, err_msg=name)
    # the teacher-forced forward + ce_for_language_model gives the same loss
    port.fused_cap_loss = False
    unfused, u_writes = port.get_loss(to_torch(batch))
    np.testing.assert_allclose(unfused.item(), float(want), **TOL)
    np.testing.assert_allclose(u_writes["train/cap/loss"].item(),
                               float(w_writes["train/cap/loss"]), **TOL)


@pytest.mark.parametrize("feed,decoder", [
    ("dense", ("butd", "new", "GRU")), ("int8", ("butd", "new", "GRU")),
    ("int8", ("butd", "base", "LSTM")), ("dense", ("base", "new", "GRU"))])
def test_caption_loss_matches_unfused_and_chunked(rng, feed, decoder,
                                                  monkeypatch):
    """caption_loss (the vocab head after the steps; the custom-backward
    scan for the BUTD GRU decoder with MultiplyAttention, else the decoder's
    steps with the hoisted word-RNN gates) equals the teacher-forced forward
    + ce_for_language_model, with its gradients, and so does the row-chunked
    CE (checkpointed chunks)."""
    _, _, port = twins(rng, decoder_type=decoder[0], att_type=decoder[1],
                       rnn_type=decoder[2])
    port.train()
    tb = to_torch(make_batch(rng, feed))

    def loss_and_grads(fn):
        port.zero_grad()
        loss = fn()
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             port.generator.named_parameters()}

    gen = port.generator

    def unfused():
        cap = gen(port.encoder(tb))
        return ce_for_language_model(cap["predict"], cap["target"], cap["mask"])

    want = loss_and_grads(unfused)
    fused = loss_and_grads(lambda: gen.caption_loss(port.encoder(tb))["loss"])
    # 3 rows of 40 f32 logits a chunk: 14 chunks over the 42 rows
    monkeypatch.setattr(type(gen), "CE_CHUNK_BYTES", 3 * NTOKEN * 4)
    chunked = loss_and_grads(lambda: gen.caption_loss(port.encoder(tb))["loss"])
    for got in (fused, chunked):
        np.testing.assert_allclose(got[0], want[0], **TOL)
        for name, g in got[1].items():
            atol = 1e-6 if name == "attention.linear.bias" else TOL["atol"]
            np.testing.assert_allclose(g.numpy(), want[1][name].numpy(),
                                       rtol=TOL["rtol"], atol=atol,
                                       err_msg=name)


def test_caption_loss_follows_a_bucketed_caption_axis(rng):
    """A caption axis cut below c_len (the Loader's length buckets) runs
    fewer steps for the same loss when no caption is longer."""
    _, _, port = twins(rng)
    port.train()
    batch = make_batch(rng, "int8")
    batch["cap_len"] = np.minimum(batch["cap_len"], 4)
    full = port.get_loss(to_torch(batch))[1]["train/cap/loss"]
    batch["c"] = batch["c"][:, :5]
    cut = port.get_loss(to_torch(batch))[1]["train/cap/loss"]
    np.testing.assert_allclose(cut.item(), full.item(), **TOL)


def run_port_trajectory(port, batches, n_steps, compute_dtype=None):
    opt = make_optimizer(port, **OPT)
    state = TrainState(port, opt, seed=7)
    step = make_train_step(port, opt, compute_dtype=compute_dtype)
    return [step(state, to_torch(batches[i % len(batches)]))
            for i in range(n_steps)], state


def test_train_trajectory_matches_jax(rng):
    """Five steps of make_train_step + make_optimizer (clip, grouped
    Adamax, StepLR from the second epoch of 2 steps) against vqa_tpu's:
    losses per step and final parameters, f32, dropout 0."""
    jm, params, port = twins(rng)
    batches = [make_batch(rng, feed) for feed in ("int8", "dense", "int8")]
    tx = jax_optim.make_optimizer(**OPT)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          step=jnp.int32(0), rng=jax.random.key(0))
    jstep = jax_make_train_step(jm, tx)
    want = []
    for i in range(5):
        state, m = jstep(state, to_jax(batches[i % 3]))
        want.append(float(m["loss"]))
    metrics, _ = run_port_trajectory(port, batches, 5)
    np.testing.assert_allclose([m["loss"].item() for m in metrics], want,
                               **TOL)
    want_p = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       state.params))
    for name, p in port.named_parameters():
        if name in SOFTMAX_BIASES:   # noise-driven Adamax updates, unread
            continue
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)


def test_bf16_step_with_dropout_gives_finite_f32_grads(rng):
    """The shipping recipe on the CPU: bf16 compute over f32 masters,
    dropout 0.5 / 0.2 active, int8 feed. Gradients, moments and
    parameters stay f32 and finite; the step is reproducible from (run
    seed, step)."""
    _, _, port = twins(rng, dropout=0.5, att_dropout=0.2)
    p0 = {n: p.detach().clone() for n, p in port.named_parameters()}
    batches = [make_batch(rng, "int8")]
    metrics, state = run_port_trajectory(port, batches, 2, torch.bfloat16)
    assert state.step == 2
    for m in metrics:
        assert set(m) == {"loss", "grad_norm", "train/loss", "train/score",
                          "train/cap/loss"}
        assert all(torch.isfinite(v).all() for v in m.values())
        assert m["loss"].dtype == torch.float32
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all(), name
        st = state.optimizer.adamax.state[p]
        assert st["exp_avg"].dtype == torch.float32
    assert not torch.equal(p0["generator.word_rnn.weight_hh"],
                           port.generator.word_rnn.weight_hh)
    # the same run seed and step draw the same masks: the same loss again
    _, _, again = twins(np.random.default_rng(1111), dropout=0.5,
                        att_dropout=0.2)
    again.load_state_dict(p0)
    m2, _ = run_port_trajectory(again, batches, 1, torch.bfloat16)
    assert m2[0]["loss"].item() == metrics[0]["loss"].item()
    assert step_seeds(7, 0) != step_seeds(7, 1)


def test_optimizer_groups_and_schedule(rng):
    """log_vars train with the encoder, the predictor at lr_vqa, the
    generator at lr_cap; the StepLR factor by epoch after warm_up."""
    _, _, port = twins(rng)
    opt = make_optimizer(port, **OPT)
    names = {id(p): n for n, p in port.named_parameters()}
    groups = {g["name"]: g for g in opt.adamax.param_groups}
    assert {g: groups[g]["base_lr"] for g in groups} == \
        {"enc": 2e-3, "vqa": 4e-3, "cap": 3e-3}
    members = {g: {names[id(p)].split(".")[0] for p in groups[g]["params"]}
               for g in groups}
    assert members == {"enc": {"encoder", "log_vars"}, "vqa": {"predictor"},
                       "cap": {"generator"}}
    assert [opt.lr_factor(u) for u in range(8)] == \
        [1, 1, 1, 1, 0.5, 0.5, 0.25, 0.25]
    assert steplr_factor(5, 3, 2, 0.25) == 0.25 and steplr_factor(9, 0, 0, 0.1) == 1


def test_eval_and_infer_steps(rng):
    _, _, port = twins(rng)
    tb = to_torch(make_batch(rng, "int8"))
    score, label, bound = make_eval_step(port)(tb)
    logits = make_infer_step(port)(tb)
    assert score.shape == label.shape == bound.shape == (B,)
    assert logits.shape == (B, ANS)
    assert torch.equal(label, logits.argmax(1))
    assert bool((score <= bound + 1e-6).all())


def test_set_model_without_a_device_needs_cuda(monkeypatch):
    """With no CUDA device the caller must ask for the CPU: no silent
    fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        set_model(**dims())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wrapper.resolve_device()
    assert wrapper.resolve_device("cpu") == torch.device("cpu")
    model = set_model(**dims(), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
