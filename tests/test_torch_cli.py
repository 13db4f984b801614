"""The port's entry point (python -m vqa_tpu_torch.main) and the modules
under it (config, training/train.py, training/checkpoint.py,
data/loader.py prefetch_to_device) against the JAX package's.

On the CPU with --device cpu, over one synthetic mini-split: the parsed
flags equal vqa_tpu.config's; evaluate and train give vqa_tpu's numbers
from the same weights (f32, dropout 0; within 1e-5 relative); checkpoints
round-trip exactly and resume where the run left off; and the CLI, as real
subprocesses in the style of tests/test_cli.py, trains, validates, resumes
and decodes with the JAX entry point's artifact layout.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.config import parse_args as jax_parse_args
from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.training import optim as jax_optim
from vqa_tpu.training import train as jax_train
from vqa_tpu.training.logging import Logger as JaxLogger
from vqa_tpu.training.state import TrainState as JaxTrainState
from vqa_tpu.training.state import make_eval_step as jax_make_eval_step
from vqa_tpu_torch import main as port_main
from vqa_tpu_torch.config import parse_args
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader, prefetch_to_device
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.training import checkpoint as ckpt
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.training.logging import Logger
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import (
    TrainState, make_eval_step, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, LR, RTOL = 8, 2e-3, 1e-5


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One synthetic root (24 train questions, 12 val) for every test."""
    path = tmp_path_factory.mktemp("torch_cli")
    root = make_synthetic_root(str(path), num_images=6, num_questions=24)
    make_synthetic_root(str(path), split="val2014", num_images=4,
                        num_questions=12, seed=9)
    return path, root


def common_args(root, extra, device="cpu"):
    return [
        "--vocab_path", root["vocab_path"],
        "--ans_path", root["ans_path"],
        "--load_path", root["annot"],
        "--feature_path", root["feature_root"],
        "--select_path", root["select_path"],
        "--pretrained_embed_path", "",
        "--embed_dim", "16", "--hidden_dim", "24",
        "--decoder_hidden_dim", "20", "--v_dim", str(root["v_dim"]),
        "--batch_size", str(BATCH), "--epoches", "1",
    ] + (["--device", device] if device else []) + extra


def run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "vqa_tpu_torch.main"] + args,
                          cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    return proc


@pytest.mark.parametrize("argv", [
    [],
    ["--mode", "val", "--comment", "x", "--batch_size", "64",
     "--use_pallas", "1", "--feature_dtype", "int8"],
    # the type=bool trap, kept: "False" is a non-empty string, so True
    ["--use_mtl", "False", "--shuffle", "0", "--load_setting", ""],
    ["--mode", "decode", "--decode_dtype", "bfloat16", "--length_bucket", "1",
     "--bucket_bounds", "8,12", "--lr", "1e-3", "--epoches", "3"],
])
def test_parse_args_matches_jax(argv):
    """The port's flags equal vqa_tpu.config's attribute for attribute,
    defaults included, but --device: the port's builds on it."""
    got, want = vars(parse_args(argv)), vars(jax_parse_args(argv))
    assert got.pop("device") == "cuda" and want.pop("device") == ""
    assert got == want
    assert vars(parse_args(argv + ["--device", "cpu"]))["device"] == "cpu"


VQA_DIMS = dict(encoder_type="base", predictor_type="base",
                decoder_type="none", embed_dim=16, hidden_dim=24,
                decoder_hidden_dim=20, att_type="new", dropout=0.0,
                att_dropout=0.0)


def vqa_twins(root):
    """vqa_tpu's config-1 model with its init params, and the port's model
    (CPU) with the same weights."""
    dims = dict(VQA_DIMS, ntoken=root["ntoken"], v_dim=root["v_dim"],
                ans_dim=root["ans_dim"])
    jm = jax_set_model(**dims)
    ds = jax_set_dataset(root["annot"], root["feature_root"], root["ans_dim"],
                         is_val=True, dataset_type="vqa")
    sample = jax_train.model_batch(next(iter(JaxLoader(ds, BATCH))))
    params = jm.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in
                                         sample.items()})["params"]
    port = set_model(**dims, device="cpu")
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, port


def loaders(root, train: bool, shuffle: bool = False):
    """(vqa_tpu's Loader, the port's) over the same split."""
    kw = dict(is_train=train, is_val=not train, dataset_type="vqa")
    args = (root["annot"], root["feature_root"], root["ans_dim"])
    return (JaxLoader(jax_set_dataset(*args, **kw), BATCH, shuffle=shuffle),
            Loader(set_dataset(*args, **kw), BATCH, shuffle=shuffle))


def test_evaluate_matches_jax(workdir):
    """Score, bound and the per-answer-type dict of the same weights."""
    _, root = workdir
    jm, params, port = vqa_twins(root)
    with open(root["index_path"]) as f:
        ans_index = json.load(f)
    jl, pl = loaders(root, train=False)
    want = jax_train.evaluate(jax_make_eval_step(jm), params, jl)
    got = port_train.evaluate(make_eval_step(port), pl, "cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    want = jax_train.evaluate(jax_make_eval_step(jm), params, jl,
                              ans_index=ans_index)
    got = port_train.evaluate(make_eval_step(port), pl, "cpu",
                              ans_index=ans_index)
    assert set(got) == set(want) == {"hparam/yes/no", "hparam/number",
                                     "hparam/other", "hparam/score"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def scalars(save_path, tag):
    with open(os.path.join(save_path, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r.get("tag") == tag]


def test_train_matches_jax(workdir, tmp_path, monkeypatch):
    """train() of both packages from the same weights, f32, dropout 0, two
    epochs of the three shuffled batches of the split: every step's loss
    (so each epoch's avg_loss), each epoch's val score and the final
    parameters agree."""
    monkeypatch.chdir(tmp_path)
    _, root = workdir
    jm, params, port = vqa_twins(root)
    steps, epochs = 3, 2
    opt = dict(lr=LR, max_norm=0.25, warm_up=0, step_size=1, gamma=0.5)
    tx = jax_optim.make_optimizer(steps_per_epoch=steps, **opt)
    common = dict(num_epoches=epochs, seed=7, train_dtype="float32", **opt)
    jl, jv = loaders(root, train=True, shuffle=True)[0], loaders(root, False)[0]
    state = jax_train.train(
        model=jm, train_loader=jl, val_loader=jv,
        logger=JaxLogger("jax", root=str(tmp_path)),
        save_path=str(tmp_path / "jax"),
        init_state=JaxTrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.int32(0), rng=jax.random.key(0)),
        **common)
    pl, pv = loaders(root, train=True, shuffle=True)[1], loaders(root, False)[1]
    assert len(pl) == steps
    got_state = port_train.train(
        model=port, train_loader=pl, val_loader=pv,
        logger=Logger("port", root=str(tmp_path)),
        save_path=str(tmp_path / "port"), **common)
    assert got_state.step == int(state.step) == steps * epochs
    losses = [scalars(tmp_path / p, "train/loss") for p in ("port", "jax")]
    assert len(losses[0]) == len(losses[1]) == steps * epochs
    np.testing.assert_allclose(losses[0], losses[1], rtol=RTOL)
    for e in range(epochs):
        np.testing.assert_allclose(np.mean(losses[0][e * steps:(e + 1) * steps]),
                                   np.mean(losses[1][e * steps:(e + 1) * steps]),
                                   rtol=RTOL)
    evals = [scalars(tmp_path / p, "train/eval") for p in ("port", "jax")]
    assert len(evals[0]) == epochs
    np.testing.assert_allclose(evals[0], evals[1], rtol=RTOL)
    want_p = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       state.params))
    for name, p in port.named_parameters():
        if name == "encoder.attention.linear.bias":   # unread under softmax
            continue
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for p in ("port", "jax"):
        names = os.listdir(tmp_path / p)
        assert {"epoch_0.ckpt", "epoch_1.ckpt", "best_model.ckpt"} <= set(names)


MTL_DIMS = dict(encoder_type="base", predictor_type="base",
                decoder_type="butd", embed_dim=16, hidden_dim=32,
                decoder_hidden_dim=32, att_type="new", use_mtl=True,
                use_pallas=True)


def mtl_setup(root, seed: int):
    """The port's MTL model (dropout 0.5 / 0.2 active), its state, its step
    and three int8-feed batches."""
    model = set_model(**MTL_DIMS, ntoken=root["ntoken"], v_dim=root["v_dim"],
                      ans_dim=root["ans_dim"], c_len=root["c_len"],
                      generator=torch.Generator().manual_seed(seed),
                      device="cpu")
    state = TrainState(model, make_optimizer(model, lr=LR, steps_per_epoch=3),
                       seed=11)
    ds = set_dataset(root["annot"], root["feature_root"], root["ans_dim"],
                     is_train=True, dataset_type="vqa-e", feature_mode="int8")
    batches = list(prefetch_to_device(
        (port_train.model_batch(b) for b in Loader(ds, BATCH)), "cpu"))
    return state, make_train_step(model, state.optimizer), batches


def test_checkpoint_round_trip_and_resume(workdir, tmp_path):
    """A checkpoint restores parameters, Adamax moments, step, seed and
    best_score exactly, and training resumed from it takes the step the
    uninterrupted run takes."""
    _, root = workdir
    state, step, batches = mtl_setup(root, 0)
    straight = [step(state, b)["loss"].item() for b in batches]

    state, step, batches = mtl_setup(root, 0)
    for b in batches[:2]:
        step(state, b)
    path = str(tmp_path / "epoch_0.ckpt")
    ckpt.save_checkpoint(path, state, epoch=0, best_score=0.25)
    fresh, fresh_step, _ = mtl_setup(root, 5)     # other weights
    restored = ckpt.load_checkpoint(path, fresh)
    assert restored["epoch"] == 0 and restored["best_score"] == 0.25
    assert fresh.step == 2 and fresh.seed == 11
    for (n, p), q in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), n
    want_opt = state.optimizer.adamax.state_dict()["state"]
    got_opt = fresh.optimizer.adamax.state_dict()["state"]
    assert set(got_opt) == set(want_opt)
    for i in want_opt:
        for key in ("exp_avg", "exp_inf", "step"):
            assert torch.equal(got_opt[i][key], want_opt[i][key]), (i, key)
    resumed = fresh_step(fresh, batches[2])["loss"].item()
    np.testing.assert_allclose(resumed, straight[2], rtol=1e-6)
    params = ckpt.load_params(path)
    assert set(params) == set(state.model.state_dict())
    # merge_params: entries of matching shape come over, others stay
    target = {"a": torch.zeros(2), "b": torch.zeros(3)}
    merged = ckpt.merge_params(target, {"a": torch.ones(2), "b": torch.ones(4),
                                        "c": torch.ones(1)})
    assert torch.equal(merged["a"], torch.ones(2)) and merged["b"] is target["b"]
    assert set(merged) == {"a", "b"}


def test_interrupted_save_leaves_no_partial_file(workdir, tmp_path,
                                                 monkeypatch):
    _, root = workdir
    state, _, _ = mtl_setup(root, 0)
    path = str(tmp_path / "best_model.ckpt")

    def torn_save(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    real_save = torch.save
    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, state, 0, 0.5)
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(torch, "save", real_save)
    ckpt.save_checkpoint(path, state, 0, 0.5)
    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(path, state, 1, 0.75)
    assert os.listdir(tmp_path) == ["best_model.ckpt"]
    assert ckpt.load_checkpoint(path)["best_score"] == 0.5
    # the asynchronous writer reports the same failure when joined
    writer = ckpt.Checkpointer()
    writer.save_checkpoint_async(str(tmp_path / "epoch_3.ckpt"), state, 3)
    with pytest.raises(OSError, match="disk full"):
        writer.wait_for_checkpoints()
    writer.close()
    assert os.listdir(tmp_path) == ["best_model.ckpt"]


def test_prefetch_to_device_on_the_cpu(workdir):
    """On the CPU the batches pass through as tensors equal to the host
    arrays; nvalid and the ids stay host values; keys select the entries."""
    _, root = workdir
    loader = loaders(root, train=False)[1]
    host = list(loader)
    got = list(prefetch_to_device(iter(host), "cpu", size=2))
    assert len(got) == len(host) == 2
    for g, h in zip(got, host):
        assert set(g) == set(h)
        assert isinstance(g["nvalid"], np.integer) and isinstance(g["id"], np.ndarray)
        for key in ("img", "q", "a"):
            assert torch.is_tensor(g[key])
            np.testing.assert_array_equal(g[key].numpy(), h[key])
    assert [int(g["nvalid"]) for g in got] == [8, 4]
    only = next(prefetch_to_device(iter(host), "cpu", keys=("q",)))
    assert torch.is_tensor(only["q"]) and isinstance(only["img"], np.ndarray)


def test_cli_train_and_val_vqa(workdir):
    """CONFIGS.md config 1 through the port's CLI: the JAX entry point's
    artifacts, then val mode on the best model."""
    path, root = workdir
    flags = ["--comment", "port_vqa", "--predictor_type", "base",
             "--decoder_type", "none", "--select_path", "vqa"]
    proc = run_cli(common_args(root, ["--mode", "train"] + flags), path)
    out = path / "checkpoint" / "port_vqa"
    for name in ("param.pkl", "param.txt", "epoch_0.ckpt", "best_model.ckpt",
                 "scalars.jsonl", "valid/scores.npy", "valid/labels.npy"):
        assert (out / name).exists(), name
    assert any(n.endswith("_log.txt") for n in os.listdir(out))
    assert "hparam/score" in proc.stdout
    with open(out / "param.pkl", "rb") as f:
        assert pickle.load(f)["device"] == "cpu"
    assert len(np.load(out / "valid" / "scores.npy")) == 12
    proc = run_cli(common_args(root, ["--mode", "val"] + flags), path)
    assert "hparam/yes/no" in proc.stdout


def test_cli_mtl_train_resume_and_decode(workdir):
    """A small MTL model (int8 feed, the kernels' plain versions, length
    buckets, bf16 training): train one epoch, resume from epoch_0.ckpt for a
    second, then beam-decode one caption per val question in bf16."""
    path, root = workdir
    flags = ["--comment", "port_mtl", "--predictor_type", "base",
             "--decoder_type", "butd", "--select_path", "vqa-e",
             "--use_mtl", "1", "--use_pallas", "1", "--feature_dtype", "int8",
             "--length_bucket", "1", "--hidden_dim", "32",
             "--decoder_hidden_dim", "32", "--c_len", str(root["c_len"])]
    run_cli(common_args(root, ["--mode", "train"] + flags), path)
    out = path / "checkpoint" / "port_mtl"
    first = ckpt.load_checkpoint(str(out / "epoch_0.ckpt"))
    run_cli(common_args(root, ["--mode", "train", "--start_epoch", "1",
                               "--epoches", "2"] + flags), path)
    second = ckpt.load_checkpoint(str(out / "epoch_1.ckpt"))
    assert first["epoch"] == 0 and second["epoch"] == 1
    assert second["step"] == 2 * first["step"] > 0
    assert second["optimizer"]["state"][0]["step"].item() == second["step"]
    run_cli(common_args(root, ["--mode", "decode", "--decode_dtype",
                               "bfloat16"] + flags), path)
    lines = [l for l in (out / "decode.txt").read_text().split("\n") if l]
    assert len(lines) == 12       # one caption per val question


def test_cli_needs_a_card_or_device_cpu(workdir, tmp_path, monkeypatch):
    """Without CUDA and without --device cpu the entry point raises, the
    max-relevance strategy (--train_strategy select) included; a
    tensor-parallel axis (--n_model_shards 2) wider than the world of one
    process raises, as JAX's make_mesh does."""
    _, root = workdir
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--mode", "val", "--comment", "nocard"]
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="cpu"):
            port_main.main(common_args(root, flags, device))
    select = ["--mode", "train", "--comment", "nocard", "--train_strategy",
              "select", "--predictor_type", "q-cap", "--decoder_type", "base"]
    with pytest.raises(RuntimeError, match="cpu"):
        port_main.main(common_args(root, select, None))
    with pytest.raises(ValueError, match="degenerate mesh 0x2 on 1"):
        port_main.main(common_args(root, flags) + ["--n_model_shards", "2"])
