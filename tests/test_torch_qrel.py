"""The Q-Relevant path of vqa_tpu_torch against vqa_tpu's: the q-cap head
(LReLUNet, CaptionAttention, CaptionEmbedding, PredictorwithCaption) and
the max-relevance step (per_sample_bce, get_select_loss,
make_train_select_step) with its all-captions feed
(tests/test_torch_qrel_cli.py holds the entry point and the tools).

Weights pass from the flax init through tools/convert.py; inputs come from
a seeded numpy generator or the synthetic mini-split; everything runs in f32
on the CPU with dropout off where the two packages are compared (their
random streams differ by design). Tolerances: the modules rtol 1e-5 and
atol 1e-6; per_sample_bce rtol 1e-6; the select loss and its writes rtol
1e-5, each gradient max |diff| / max |JAX| <= 1e-4 (the attention
linears' biases, whose gradient is rounding noise around 0 under the
softmax, within 1e-6 absolute); a 3-step trajectory's losses 1e-4
relative; scores 1e-4 relative.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.models.predictor import PredictorwithCaption as JaxPredictorwithCaption
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.ops.caption import CaptionAttention as JaxCaptionAttention
from vqa_tpu.ops.caption import CaptionEmbedding as JaxCaptionEmbedding
from vqa_tpu.ops.linear import LReLUNet as JaxLReLUNet
from vqa_tpu.training import optim as jax_optim
from vqa_tpu.training.select import get_select_loss as jax_get_select_loss
from vqa_tpu.training.select import make_train_select_step as jax_make_select_step
from vqa_tpu.training.select import per_sample_bce as jax_per_sample_bce
from vqa_tpu.training.state import TrainState as JaxTrainState
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.shards import quantize_features
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.predictor import PredictorwithCaption
from vqa_tpu_torch.models.wrapper import instance_bce_with_logits, set_model
from vqa_tpu_torch.ops.caption import CaptionAttention, CaptionEmbedding
from vqa_tpu_torch.ops.linear import LReLUNet
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.select import (
    get_select_loss, make_train_select_step, per_sample_bce)
from vqa_tpu_torch.training.state import TrainState

B, T, EMBED, HIDDEN, DEC_HIDDEN, V_DIM, OBJS, ANS = 6, 7, 16, 24, 20, 32, 5, 9
C_LEN = 8
# The selection is an argmin over the candidates' VQA losses. At a random
# init the caption moves those losses by ~1e-6 of ~10, within the f32
# rounding difference of the two packages (~3e-6), so the packages may pick
# different candidates, both rightly. The step tests multiply the gain of
# the head's caption layer (c_net) by CAPTION_GAIN in both packages, which
# spreads the candidates by 1e-4 or more, and check that spread
# (SELECT_MARGIN) before comparing.
CAPTION_GAIN, SELECT_MARGIN = 30.0, 3e-5
MOD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL, GRAD_REL, TRAJ_RTOL = 1e-5, 1e-4, 1e-4
SOFTMAX_BIASES = ("encoder.attention.linear.bias",
                  "generator.attention.linear.bias")
OPT = dict(lr=2e-3, lr_vqa=4e-3, lr_cap=3e-3, max_norm=0.25, warm_up=1,
           step_size=1, gamma=0.5, steps_per_epoch=2)
SELECT_KEYS = ("img", "q", "a", "c_all", "cap_len_all")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One synthetic root: 24 train questions over 6 images, 12 val;
    captions of 8 tokens."""
    path = tmp_path_factory.mktemp("torch_qrel")
    root = make_synthetic_root(str(path), num_images=6, num_questions=24,
                               c_len=C_LEN)
    make_synthetic_root(str(path), split="val2014", num_images=4,
                        num_questions=12, c_len=C_LEN, seed=9)
    return path, root


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def load_module(port, params):
    """Load a flax module's params into the port module, through the
    converter (strict)."""
    sd = flax_to_state_dict({"m": params})
    port.load_state_dict({k[len("m."):]: v for k, v in sd.items()})
    return port


def init(module, *args):
    return jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.key(3), *args)["params"])


# -- the modules ------------------------------------------------------------

def test_lrelu_net_matches_jax(rng):
    """A bias-free Linear and LeakyReLU(0.01); its weight is
    ``main.0.weight`` [out, in]."""
    x = rng.standard_normal((B, T, V_DIM)).astype(np.float32)
    jm = JaxLReLUNet(HIDDEN)
    params = init(jm, jnp.asarray(x))
    port = load_module(LReLUNet(V_DIM, HIDDEN), params)
    assert set(port.state_dict()) == {"main.0.weight"}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    assert (want < 0).any()
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)


def test_caption_attention_matches_jax(rng):
    h = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    v = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    q = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    jm = JaxCaptionAttention(HIDDEN)
    params = init(jm, *map(jnp.asarray, (h, v, q)))
    port = load_module(CaptionAttention(HIDDEN, HIDDEN, HIDDEN), params).eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (h, v, q)))
    want = jm.apply({"params": params}, *map(jnp.asarray, (h, v, q)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


@pytest.mark.parametrize("lengths,rnn_type", [
    ("none", "GRU"), ("ragged", "GRU"), ("one", "GRU"), ("ragged", "LSTM")])
def test_caption_embedding_matches_jax(rng, lengths, rnn_type):
    """Word RNN, gate, caption RNN, LReLU layer and the max over the valid
    steps, padded steps counting as 0: a plain max without ``cap_len``,
    ragged lengths, and rows of length 1."""
    v = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    q = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    c = rng.standard_normal((B, T, EMBED)).astype(np.float32)
    cap_len = {"none": None,
               "ragged": rng.integers(1, T + 1, B).astype(np.int32),
               "one": np.ones(B, np.int32)}[lengths]
    jm = JaxCaptionEmbedding(HIDDEN, rnn_type=rnn_type)
    jargs = [jnp.asarray(a) for a in (v, q, c)] + [
        None if cap_len is None else jnp.asarray(cap_len)]
    params = init(jm, *jargs)
    port = load_module(CaptionEmbedding(EMBED, HIDDEN, HIDDEN, HIDDEN,
                                        rnn_type=rnn_type), params).eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (v, q, c)),
                   None if cap_len is None else torch.from_numpy(cap_len))
    want = np.asarray(jm.apply({"params": params}, *jargs))
    assert got.shape == (B, HIDDEN)
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)
    if lengths == "one":
        # one valid step: its LReLU output where positive, else the zeros of
        # the padded steps
        assert (got >= 0).all() and (got == 0).any()


@pytest.mark.parametrize("with_len", [False, True])
def test_predictor_with_caption_matches_jax(rng, with_len):
    """The q-cap head on an encoder output: the boxes' LReLU projection, the
    gated caption embedding, the softmax over the hidden axis, the sigmoid
    output."""
    embed = {"v": rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32),
             "q": rng.standard_normal((B, HIDDEN)).astype(np.float32),
             "c": rng.standard_normal((B, T, EMBED)).astype(np.float32)}
    if with_len:
        embed["cap_len"] = rng.integers(1, T + 1, B).astype(np.int32)
    jm = JaxPredictorwithCaption(HIDDEN, ANS)
    params = init(jm, to_jax(embed))
    port = load_module(PredictorwithCaption(V_DIM, EMBED, HIDDEN, ANS),
                       params).eval()
    with torch.no_grad():
        got = port(to_torch(embed))
    want = np.asarray(jm.apply({"params": params}, to_jax(embed)))
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)


def test_per_sample_bce_matches_jax(rng):
    """Per-row BCE-with-logits (the mean over answers times their number),
    whose batch mean is instance_bce_with_logits; bf16 logits run in f32."""
    p = rng.standard_normal((B, ANS)).astype(np.float32) * 3
    t = (rng.integers(0, 4, (B, ANS)) / 3.0).astype(np.float32)
    got = per_sample_bce(torch.from_numpy(p), torch.from_numpy(t))
    want = np.asarray(jax_per_sample_bce(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.mean().item(),
        instance_bce_with_logits(torch.from_numpy(p), torch.from_numpy(t)).item(),
        rtol=1e-6)
    assert per_sample_bce(torch.from_numpy(p).to(torch.bfloat16),
                          torch.from_numpy(t)).dtype == torch.float32


# -- the max-relevance step -------------------------------------------------

CONFIG4 = dict(encoder_type="base", predictor_type="base-cap",
               decoder_type="base", att_type="new", use_mtl=False)
QCAP_BUTD = dict(encoder_type="base", predictor_type="q-cap",
                 decoder_type="butd", att_type="new", use_mtl=True)


def select_dims(root, over):
    return dict(ntoken=root["ntoken"], v_dim=root["v_dim"], embed_dim=EMBED,
                hidden_dim=HIDDEN, decoder_hidden_dim=DEC_HIDDEN,
                ans_dim=root["ans_dim"], c_len=root["c_len"], dropout=0.0,
                att_dropout=0.0, **over)


def all_batch(root, questions):
    """get_batch_all of vqa_tpu's all-captions dataset: the step's keys."""
    ds = jax_set_dataset(root["annot"], root["feature_root"], root["ans_dim"],
                         caption_id_path=root["select_path"], is_train=True,
                         dataset_type="all")
    raw = ds.get_batch_all(list(questions))
    return {k: raw[k] for k in SELECT_KEYS}


def select_twins(root, over, sample):
    """vqa_tpu's model with params initialised through get_select_loss (the
    caption layer's gain times CAPTION_GAIN), and the port's (CPU) with the
    same weights."""
    jm = jax_set_model(**select_dims(root, over))
    params = jm.init(jax.random.key(0), to_jax(sample),
                     method=functools.partial(jax_get_select_loss,
                                              deterministic=True))["params"]
    c_net = params["predictor"]["c_net"]
    if "w" in c_net:                               # q-cap: an LReLUNet
        c_net["w"] = c_net["w"] * CAPTION_GAIN
    else:                                          # base-cap: an FCNet
        c_net["fc0"]["g"] = c_net["fc0"]["g"] * CAPTION_GAIN
    port = set_model(**select_dims(root, over), device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, port


@pytest.mark.parametrize("over", [CONFIG4, QCAP_BUTD],
                         ids=["config4", "qcap_butd_mtl"])
def test_select_loss_and_grads_match_jax(workdir, over):
    """get_select_loss (candidate expansion, selection, the unfused caption
    loss, the MTL weights) and the gradient of every parameter against
    jax.value_and_grad of vqa_tpu's."""
    _, root = workdir
    batch = all_batch(root, range(6))
    jm, params, port = select_twins(root, over, batch)
    jb = to_jax(batch)

    def jloss(p):
        return jm.apply({"params": p}, jb,
                        method=functools.partial(jax_get_select_loss,
                                                 deterministic=False),
                        rngs={"dropout": jax.random.key(1)})

    (want, w_writes), w_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    assert_spread(port, to_torch(batch))
    port.train()
    got, writes = get_select_loss(port, to_torch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert set(writes) == set(w_writes) == {"train/loss", "train/score",
                                             "train/cap/loss"}
    for key in writes:
        np.testing.assert_allclose(writes[key].item(), float(w_writes[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, w_grads))
    got_g = {n: p.grad for n, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        w = want_g[name].numpy()
        diff = np.abs(g.numpy() - w).max()
        if name in SOFTMAX_BIASES:
            assert diff <= 1e-6, (name, diff)
        else:
            assert diff <= GRAD_REL * np.abs(w).max(), (name, diff,
                                                        np.abs(w).max())


def test_select_loss_forms_v_on_the_int8_feed(workdir):
    """Without a caption decoder, the base-cap model's encoder forms no dense
    ``v`` on the int8 feed; get_select_loss forms it as the JAX encoder
    forms ``out["v"]``, so the loss equals that of the same encoder forming
    ``v`` itself."""
    _, root = workdir
    batch = all_batch(root, range(6))
    batch["img_q"], batch["img_scale"] = quantize_features(batch.pop("img"))
    tb = to_torch(batch)
    port = set_model(**select_dims(root, dict(CONFIG4, decoder_type="none")),
                     generator=torch.Generator().manual_seed(5), device="cpu")
    port.eval()
    with torch.no_grad():
        assert "v" not in port.encoder(
            {k: tb[k] for k in ("img_q", "img_scale", "q")})
        formed = get_select_loss(port, tb)[0]
        port.encoder.with_v = True
        own = get_select_loss(port, tb)[0]
    assert torch.isfinite(formed) and torch.equal(formed, own)


def test_train_select_trajectory_matches_jax(workdir):
    """Three steps of make_train_select_step (the clip, grouped Adamax,
    StepLR from the second epoch of 2 steps) against vqa_tpu's with its
    optax Adamax: the loss of each step, q-cap with BUTD and use_mtl."""
    _, root = workdir
    batches = [all_batch(root, range(6 * i, 6 * i + 6)) for i in range(3)]
    jm, params, port = select_twins(root, QCAP_BUTD, batches[0])
    tx = jax_optim.make_optimizer(**OPT)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          step=jnp.int32(0), rng=jax.random.key(0))
    jstep = jax_make_select_step(jm, tx)
    want = []
    for b in batches:
        state, m = jstep(state, to_jax(b))
        want.append(float(m["loss"]))
    opt = make_optimizer(port, **OPT)
    pstate = TrainState(port, opt, seed=7)
    step = make_train_select_step(port, opt, compute_dtype=None)
    got = []
    for b in batches:
        assert_spread(port, to_torch(b))
        got.append(step(pstate, to_torch(b))["loss"].item())
    assert pstate.step == 3
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_select_ties_take_the_first_candidate(workdir):
    """Five candidates with the same tokens and other lengths: base-cap
    ignores the length, so their VQA losses tie exactly, and both packages
    select candidate 0, whose length the caption loss then masks with."""
    _, root = workdir
    batch = all_batch(root, range(6))
    batch["c_all"] = np.repeat(batch["c_all"][:, :1], 5, axis=1)
    batch["cap_len_all"] = np.tile(np.arange(5, 15, 2, dtype=np.int32), (6, 1))
    jm, params, port = select_twins(root, CONFIG4, batch)
    port.eval()
    per = candidate_losses(port, to_torch(batch))
    with torch.no_grad():
        _, writes = get_select_loss(port, to_torch(batch))
        alone = [get_select_loss(port, to_torch(
            dict(batch, c_all=batch["c_all"][:, j:j + 1],
                 cap_len_all=batch["cap_len_all"][:, j:j + 1])))[1]
            ["train/cap/loss"].item() for j in (0, 1)]
    assert (per == per[:, :1]).all(), "the candidates do not tie"
    _, w_writes = jm.apply({"params": params}, to_jax(batch),
                           method=functools.partial(jax_get_select_loss,
                                                    deterministic=True))
    assert alone[0] != alone[1]
    np.testing.assert_allclose(writes["train/cap/loss"].item(), alone[0],
                               rtol=1e-6)
    np.testing.assert_allclose(float(w_writes["train/cap/loss"]), alone[0],
                               rtol=LOSS_RTOL)


def candidate_losses(port, batch):
    """The per-candidate VQA losses [B, n] of get_select_loss, in eval
    mode."""
    training = port.training
    port.eval()
    with torch.no_grad():
        n = batch["c_all"].shape[1]
        per = per_sample_bce(port.predictor(_candidates(port, batch)),
                             batch["a"].repeat_interleave(n, 0))
    port.train(training)
    return per.reshape(-1, n)


def assert_spread(port, batch):
    """Each question's best candidate leads the next by SELECT_MARGIN."""
    top2 = torch.topk(candidate_losses(port, batch), 2, largest=False).values
    gap = (top2[:, 1] - top2[:, 0]).min().item()
    assert gap > SELECT_MARGIN, gap


def _candidates(port, batch):
    """The expanded predictor input of get_select_loss, rebuilt."""
    embed = port.encoder({"img": batch["img"], "q": batch["q"]})
    n = batch["c_all"].shape[1]
    c = port.encoder.embed(batch["c_all"])
    return {"v": embed["v"].repeat_interleave(n, 0),
            "q": embed["q"].repeat_interleave(n, 0),
            "c": c.reshape(-1, *c.shape[2:]),
            "cap_len": batch["cap_len_all"].reshape(-1)}


def test_selection_gradient_routing(workdir, monkeypatch):
    """The gradient reaches the selected candidate caption alone: the
    embedded candidates' gradient is zero on every other one; and, as
    vqa_tpu's test probes it, padding out a candidate changes the loss only
    where it was (or becomes) the selected one."""
    _, root = workdir
    over = dict(CONFIG4, decoder_type="none")
    batch = to_torch(all_batch(root, range(4)))
    port = set_model(**select_dims(root, over), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    sel = candidate_losses(port, batch).argmin(dim=1)
    port.train()
    captured = []
    real_embed = port.encoder.embed

    def embed(tokens):
        out = real_embed(tokens)
        if tokens.dim() == 3:            # the candidates [B, n, T]
            out.retain_grad()
            captured.append(out)
        return out

    monkeypatch.setattr(port.encoder, "embed", embed)
    loss, _ = get_select_loss(port, batch)
    loss.backward()
    grad = captured[0].grad.abs().sum(dim=(2, 3))          # [B, n]
    for b in range(4):
        for j in range(5):
            assert (grad[b, j] > 0) == (j == sel[b]), (b, j, grad[b])

    monkeypatch.setattr(port.encoder, "embed", real_embed)
    with torch.no_grad():
        loss0 = get_select_loss(port, batch)[0].item()
        changed = []
        for cand in range(5):
            c_mod = batch["c_all"].clone()
            c_mod[0, cand] = root["ntoken"] - 1
            loss1 = get_select_loss(port, dict(batch, c_all=c_mod))[0].item()
            changed.append(abs(loss1 - loss0) > 1e-7)
    assert 1 <= sum(changed) <= 2 and changed[int(sel[0])]


# -- the all-captions feed ----------------------------------------------------

def test_get_batch_all_and_an_epoch_match_jax(workdir):
    """get_batch_all (c_all [B, 5, c_len], cap_len_all [B, 5]) and a whole
    shuffled epoch of Loader(batch_method="get_batch_all", length=the
    questions) with an odd tail, key by key against vqa_tpu.data."""
    _, root = workdir
    args = (root["annot"], root["feature_root"], root["ans_dim"])
    kw = dict(caption_id_path=root["select_path"], is_train=True,
              dataset_type="all")
    mine, theirs = set_dataset(*args, **kw), jax_set_dataset(*args, **kw)
    got = mine.get_batch_all([3, 0, 17])
    want = theirs.get_batch_all([3, 0, 17])
    assert set(got) == set(want)
    assert got["c_all"].shape == (3, 5, root["c_len"])
    assert got["cap_len_all"].shape == (3, 5)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    n = len(mine.questions)
    assert len(mine) == 5 * n
    loaders = [L(ds, 7, shuffle=True, seed=5, batch_method="get_batch_all",
                 length=n) for L, ds in ((Loader, mine), (JaxLoader, theirs))]
    assert len(loaders[0]) == len(loaders[1]) == -(-n // 7)
    assert loaders[0].num_samples == loaders[1].num_samples == n
    for epoch in range(2):
        ours, ref = list(loaders[0]), list(loaders[1])
        assert len(ours) == len(ref) == 4
        assert [int(b["nvalid"]) for b in ours] == [7, 7, 7, 3]
        for a, b in zip(ours, ref):
            assert set(a) == set(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
