"""Frozen GloVe embeddings, the caption encoder and the caption-reading VQA
head (``base-cap``, VQA-E) of vqa_tpu_torch against vqa_tpu's.

The GloVe parser on a file the test writes; the frozen table as a buffer
outside ``state_dict``, ``parameters()``, the optimizer and checkpoints;
and the modules with the same weights (the flax init converted by
tools/convert.py) on the same seeded numpy batches, f32 on the CPU, at the
tolerance of the forward tests (rtol 1e-4, atol 1e-5), with dropout off;
then ``train()`` of CONFIGS.md config 3 (base-cap + BUTD + use_mtl) against
vqa_tpu's, as tests/test_torch_cli.py holds config 1 (1e-5 relative).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.models.encoder import set_encoder as jax_set_encoder
from vqa_tpu.models.predictor import set_predictor as jax_set_predictor
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.ops.embedding import load_glove_table as jax_load_glove_table
from vqa_tpu.training import optim as jax_optim
from vqa_tpu.training import train as jax_train
from vqa_tpu.training.logging import Logger as JaxLogger
from vqa_tpu.training.state import TrainState as JaxTrainState
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.encoder import CaptionEncoder
from vqa_tpu_torch.models.predictor import BaseCaptionPredictor
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops.embedding import load_glove_table
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.training import checkpoint as ckpt
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.training.logging import Logger
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import TrainState

B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS, C_LEN = 6, 5, 12, 16, 32, 5, 40, 9, 7
TOL = dict(rtol=1e-4, atol=1e-5)
RTOL = 1e-5


def write_glove(path, words, dim: int, seed: int = 0) -> np.ndarray:
    """A GloVe-format file, one ``word v_1 ... v_dim`` line a word, and the
    values it holds."""
    vecs = np.random.default_rng(seed).standard_normal(
        (len(words), dim)).astype(np.float32)
    with open(path, "w") as f:
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(repr(float(x)) for x in v) + "\n")
    return vecs


def glove_table(tmp_path, ntoken: int = NTOKEN, dim: int = EMBED):
    """The frozen table of a vocabulary of ``ntoken`` ids: a line for each
    word, the four specials the zero rows at the end."""
    path = str(tmp_path / "glove.txt")
    write_glove(path, [f"w{i}" for i in range(ntoken - 4)], dim)
    return load_glove_table(path)


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


def dims(**over):
    return {**dict(encoder_type="base", predictor_type="base-cap",
                   decoder_type="butd", ntoken=NTOKEN, v_dim=V_DIM,
                   embed_dim=EMBED, hidden_dim=HIDDEN,
                   decoder_hidden_dim=HIDDEN, ans_dim=ANS, c_len=C_LEN,
                   dropout=0.0, att_dropout=0.0, att_type="new",
                   use_mtl=True), **over}


def twins(rng, **over):
    """A vqa_tpu model with its init params and the port's (CPU) with the
    same weights; ``load_state_dict`` is strict."""
    jm = jax_set_model(**dims(**over))
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(0), to_jax(make_batch(rng, "dense")))["params"])
    port = set_model(**dims(**over), device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return jm, params, port


def test_load_glove_table_matches_jax(tmp_path):
    """File order, the four zero special rows at the end, the values."""
    path = str(tmp_path / "glove.txt")
    vecs = write_glove(path, ["the", "a", "cat", "sat", "on"], 7, seed=3)
    got, want = load_glove_table(path), jax_load_glove_table(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (9, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5], vecs)
    assert not got[5:].any()


def test_frozen_table_is_a_buffer_outside_the_state(tmp_path):
    """The table is in no ``state_dict``, ``parameters()``, optimizer group
    or checkpoint; it moves with the model; a converted vqa_tpu model with
    a frozen table has no embedding key and loads with ``strict=True``."""
    table = glove_table(tmp_path)
    model = set_model(**dims(), frozen_embedding=table, device="cpu")
    emb = model.encoder.embedding
    np.testing.assert_array_equal(emb.table.numpy(), table)
    assert not any("embedding" in n for n in model.state_dict())
    assert not any("embedding" in n for n, _ in model.named_parameters())
    opt = make_optimizer(model, lr=1e-3)
    in_opt = {id(p) for g in opt.adamax.param_groups for p in g["params"]}
    assert id(emb.table) not in in_opt
    assert len(in_opt) == len(list(model.parameters()))
    path = str(tmp_path / "epoch_0.ckpt")
    ckpt.save_checkpoint(path, TrainState(model, opt), epoch=0)
    assert not any("embedding" in n for n in ckpt.load_params(path))
    again = set_model(**dims(), frozen_embedding=table, device="cpu")
    again.load_state_dict(ckpt.load_params(path))
    assert model.to(torch.bfloat16).encoder.embedding.table.dtype == torch.bfloat16
    jm = jax_set_model(**dims(), frozen_embedding=table)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(0), to_jax(make_batch(np.random.default_rng(0),
                                             "dense")))["params"])
    sd = flax_to_state_dict(params)
    assert not any("embedding" in n for n in sd)
    set_model(**dims(), frozen_embedding=table, device="cpu").load_state_dict(sd)


@pytest.mark.parametrize("encoder_type,feed", [
    ("base", "dense"), ("base", "int8"), ("relation", "dense")])
def test_frozen_embedding_forward_matches_jax(rng, tmp_path, encoder_type,
                                              feed):
    """set_model(frozen_embedding=): the VQA logits, the teacher-forced
    caption logits, and the loss of the base encoder (both feeds) and of
    the relation encoder."""
    table = glove_table(tmp_path)
    over = dict(frozen_embedding=table, encoder_type=encoder_type)
    if encoder_type == "relation":
        over.update(predictor_type="base", conv_layer=1)
    jm, params, port = twins(rng, **over)
    batch = make_batch(rng, feed)
    jb, tb = to_jax(batch), to_torch(batch)
    port.eval()
    with torch.no_grad():
        predict, caption = port(tb)
        loss, writes = port.get_loss(tb)
    w_predict, w_caption = jm.apply({"params": params}, jb)
    w_loss, w_writes = jm.apply({"params": params}, jb, method="get_loss",
                                deterministic=True)
    np.testing.assert_allclose(predict.numpy(), np.asarray(w_predict), **TOL)
    np.testing.assert_allclose(caption["predict"].numpy(),
                               np.asarray(w_caption["predict"]), **TOL)
    np.testing.assert_allclose(loss.item(), float(w_loss), **TOL)
    for key in writes:
        np.testing.assert_allclose(writes[key].item(), float(w_writes[key]),
                                   **TOL)


@pytest.mark.parametrize("feed", ["dense", "int8"])
@pytest.mark.parametrize("frozen", [False, True])
def test_caption_encoder_matches_jax(rng, tmp_path, feed, frozen):
    """CaptionEncoder: ``v`` passed through (dequantized in the scale's
    dtype on the int8 feed, with the payload ``v_q8`` and the scales
    ``v_w``), the embedded caption, its tokens and lengths."""
    table = glove_table(tmp_path) if frozen else None
    jm = jax_set_encoder("cap", NTOKEN, V_DIM, EMBED, HIDDEN,
                         frozen_embedding=table)
    batch = make_batch(rng, feed)
    jb, tb = to_jax(batch), to_torch(batch)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(2), jb).get("params", {}))
    port = CaptionEncoder(NTOKEN, EMBED, table)
    sd = flax_to_state_dict({"encoder": params})
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got, emb_q = port(tb), port.embed(tb["q"])
    want = jm.apply({"params": params}, jb)
    keys = {"v", "c", "c_target", "cap_len"} | (
        {"v_q8", "v_w"} if feed == "int8" else set())
    assert set(got) == set(want) == keys
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL, err_msg=key)
    np.testing.assert_allclose(emb_q.numpy(),
                               np.asarray(jm.apply({"params": params}, jb["q"],
                                                   method="embed")), **TOL)


@pytest.mark.parametrize("pooled", [False, True])
def test_base_caption_predictor_matches_jax(rng, pooled):
    """BaseCaptionPredictor on an encoder output: the caption GRU and net,
    the joint ``q * (c + v)``, the classifier; ``v`` summed over the boxes,
    or the int8 feed's pooled ``v_sum``."""
    embed = {"q": rng.standard_normal((B, HIDDEN)).astype(np.float32),
             "v": rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32),
             "c": rng.standard_normal((B, C_LEN, EMBED)).astype(np.float32)}
    if pooled:
        embed["v_sum"] = rng.standard_normal((B, V_DIM)).astype(np.float32)
    jm = jax_set_predictor("base-cap", HIDDEN, ANS, dropout=0.5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(4), to_jax(embed))["params"])
    port = BaseCaptionPredictor(V_DIM, EMBED, HIDDEN, ANS, dropout=0.5)
    sd = flax_to_state_dict({"predictor": params})
    port.load_state_dict({k[len("predictor."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port.eval()(to_torch(embed))
    want = jm.apply({"params": params}, to_jax(embed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def scalars(save_path, tag):
    import json
    with open(os.path.join(save_path, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r.get("tag") == tag]


def test_train_config3_matches_jax(tmp_path, monkeypatch):
    """train() of CONFIGS.md config 3 (base-cap VQA head, BUTD decoder,
    use_mtl) in both packages from the same weights, with a frozen GloVe
    table, f32, dropout 0, two epochs of the shuffled batches of a VQA-E
    split: every step's VQA and caption loss, each epoch's val score and
    the final parameters agree."""
    monkeypatch.chdir(tmp_path)
    root = make_synthetic_root(str(tmp_path), num_images=6, num_questions=16,
                               num_objs=OBJS, v_dim=V_DIM, vocab_size=NTOKEN,
                               num_answers=ANS, q_len=Q_LEN, c_len=C_LEN)
    make_synthetic_root(str(tmp_path), split="val2014", num_images=4,
                        num_questions=8, num_objs=OBJS, v_dim=V_DIM,
                        vocab_size=NTOKEN, num_answers=ANS, q_len=Q_LEN,
                        c_len=C_LEN, seed=9)
    table = glove_table(tmp_path)
    over = dict(frozen_embedding=table, ntoken=root["ntoken"])
    jm = jax_set_model(**dims(**over))
    args = (root["annot"], root["feature_root"], root["ans_dim"])
    kw = dict(dataset_type="vqa-e")
    j_train = JaxLoader(jax_set_dataset(*args, is_train=True, **kw), 8,
                        shuffle=True)
    j_val = JaxLoader(jax_set_dataset(*args, is_val=True, **kw), 8)
    sample = jax_train.model_batch(next(iter(j_val)))
    params = jm.init(jax.random.key(0), to_jax(sample))["params"]
    port = set_model(**dims(**over), device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    steps, epochs = 2, 2
    opt = dict(lr=2e-3, max_norm=0.25, warm_up=0, step_size=1, gamma=0.5)
    tx = jax_optim.make_optimizer(steps_per_epoch=steps, **opt)
    common = dict(num_epoches=epochs, seed=7, train_dtype="float32", **opt)
    state = jax_train.train(
        model=jm, train_loader=j_train, val_loader=j_val,
        logger=JaxLogger("jax", root=str(tmp_path)),
        save_path=str(tmp_path / "jax"),
        init_state=JaxTrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.int32(0), rng=jax.random.key(0)),
        **common)
    p_train = Loader(set_dataset(*args, is_train=True, **kw), 8, shuffle=True)
    p_val = Loader(set_dataset(*args, is_val=True, **kw), 8)
    assert len(p_train) == steps
    got_state = port_train.train(
        model=port, train_loader=p_train, val_loader=p_val,
        logger=Logger("port", root=str(tmp_path)),
        save_path=str(tmp_path / "port"), **common)
    assert got_state.step == int(state.step) == steps * epochs
    for tag in ("train/loss", "train/cap/loss"):
        got, want = (scalars(tmp_path / p, tag) for p in ("port", "jax"))
        assert len(got) == len(want) == steps * epochs
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=tag)
    evals = [scalars(tmp_path / p, "train/eval") for p in ("port", "jax")]
    assert len(evals[0]) == epochs
    np.testing.assert_allclose(evals[0], evals[1], rtol=RTOL)
    want_p = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       state.params))
    assert set(want_p) == set(port.state_dict())
    for name, p in port.named_parameters():
        if name.endswith("attention.linear.bias"):   # unread under softmax
            continue
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
