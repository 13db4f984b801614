"""The Q-Relevant path through the port's entry point and tools against
vqa_tpu's: CONFIGS.md config 4 and its q-cap variant through python -m
vqa_tpu_torch.main --device cpu (train, then val, whose scores equal
vqa_tpu's evaluate on the same weights within 1e-4 relative), sample_vqa,
and reference checkpoints (a bare torch.save(state_dict()) file for
--load_model, the GCN convs a reference file lacks). f32 on the CPU over
the synthetic mini-split; tests/test_torch_qrel.py holds the modules and
the max-relevance step.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.tools.import_torch import import_reference_state_dict
from vqa_tpu.tools.sample import sample_vqa as jax_sample_vqa
from vqa_tpu.training import train as jax_train
from vqa_tpu.training.state import make_eval_step as jax_make_eval_step
from vqa_tpu_torch import main as port_main
from vqa_tpu_torch.config import parse_args
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.tools.sample import sample_vqa
from vqa_tpu_torch.training import checkpoint as ckpt
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMBED, HIDDEN, DEC_HIDDEN, V_DIM, ANS, C_LEN = 16, 24, 20, 32, 9, 8
SCORE_RTOL = 1e-4


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One synthetic root: 24 train questions over 6 images, 12 val;
    captions of 8 tokens."""
    path = tmp_path_factory.mktemp("torch_qrel_cli")
    root = make_synthetic_root(str(path), num_images=6, num_questions=24,
                               c_len=C_LEN)
    make_synthetic_root(str(path), split="val2014", num_images=4,
                        num_questions=12, c_len=C_LEN, seed=9)
    return path, root


def common_args(root, extra):
    return ["--vocab_path", root["vocab_path"], "--ans_path", root["ans_path"],
            "--load_path", root["annot"], "--feature_path", root["feature_root"],
            "--select_path", root["select_path"], "--pretrained_embed_path", "",
            "--embed_dim", str(EMBED), "--hidden_dim", str(HIDDEN),
            "--decoder_hidden_dim", str(DEC_HIDDEN), "--v_dim", str(root["v_dim"]),
            "--c_len", str(root["c_len"]), "--batch_size", "8", "--epoches", "1",
            "--device", "cpu"] + extra


def jax_model_of(args, root):
    """vqa_tpu's model for the parsed flags, built as its entry point
    builds it."""
    return jax_set_model(
        encoder_type=args.encoder_type, predictor_type=args.predictor_type,
        decoder_type=args.decoder_type, ntoken=root["ntoken"], v_dim=args.v_dim,
        embed_dim=args.embed_dim, hidden_dim=args.hidden_dim,
        decoder_hidden_dim=args.decoder_hidden_dim, rnn_layer=args.rnn_layer,
        ans_dim=root["ans_dim"], cls_layer=args.cls_layer, c_len=args.c_len,
        dropout=args.dropout, rnn_type=args.rnn_type, att_type=args.att_type,
        use_mtl=args.use_mtl)


def hparam_score(save_path):
    with open(os.path.join(save_path, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["metrics"]["hparam/score"] for r in rows if "metrics" in r][-1]


@pytest.mark.parametrize("predictor", ["base-cap", "q-cap"])
def test_cli_config4_trains_and_validates(workdir, tmp_path, monkeypatch,
                                          predictor):
    """CONFIGS.md config 4 (base encoder, base decoder, --train_strategy
    select over the selection pickle) and its q-cap variant through python
    -m vqa_tpu_torch.main --device cpu: one epoch of max-relevance training,
    then --mode val, whose per-question scores and score equal vqa_tpu's
    evaluate (the function its entry point's val runs) on the same
    weights, converted back by vqa_tpu's importer."""
    _, root = workdir
    comment = f"qrel_{predictor}"
    flags = ["--comment", comment, "--encoder_type", "base",
             "--predictor_type", predictor, "--decoder_type", "base",
             "--train_strategy", "select"]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.main"]
        + common_args(root, ["--mode", "train"] + flags),
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    out = tmp_path / "checkpoint" / comment
    trained = ckpt.load_checkpoint(str(out / "epoch_0.ckpt"))
    assert trained["step"] == 3            # 24 questions in batches of 8
    assert (out / "best_model.ckpt").exists()

    monkeypatch.chdir(tmp_path)
    os.remove(out / "valid" / "scores.npy")
    argv = common_args(root, ["--mode", "val"] + flags)
    port_main.main(argv)
    got_scores = np.load(out / "valid" / "scores.npy")
    assert got_scores.shape == (12,)

    args = parse_args(argv)
    jm = jax_model_of(args, root)
    params, unmapped = import_reference_state_dict(
        ckpt.load_params(str(out / "best_model.ckpt")))
    assert unmapped == []
    val = JaxLoader(jax_set_dataset(
        root["annot"], root["feature_root"], root["ans_dim"],
        caption_id_path=root["select_path"], is_val=True,
        dataset_type="select"), 8)
    score, _ = jax_train.evaluate(jax_make_eval_step(jm), params, val,
                                  save_path=str(tmp_path / "jax_valid"))
    np.testing.assert_allclose(got_scores,
                               np.load(tmp_path / "jax_valid" / "scores.npy"),
                               rtol=SCORE_RTOL)
    np.testing.assert_allclose(hparam_score(out), score, rtol=SCORE_RTOL)


# -- sample_vqa and reference checkpoints ---------------------------------------

class ListLogger:
    def __init__(self):
        self.lines = []

    def write(self, msg):
        self.lines.append(msg)


def test_sample_vqa_matches_jax(workdir):
    """The same log lines (one per batch) and answer histogram as
    vqa_tpu.tools.sample.sample_vqa on the same weights, all batches and
    the first two."""
    _, root = workdir
    dims = dict(encoder_type="base", predictor_type="base",
                decoder_type="none", ntoken=root["ntoken"],
                v_dim=root["v_dim"], embed_dim=EMBED, hidden_dim=HIDDEN,
                ans_dim=root["ans_dim"], dropout=0.0, att_type="new")
    args = (root["annot"], root["feature_root"], root["ans_dim"])
    jds = jax_set_dataset(*args, is_train=True, dataset_type="vqa")
    jm = jax_set_model(**dims)
    sample = {k: jnp.asarray(v) for k, v in jds.get_batch([0]).items()
              if k in ("img", "q", "a")}
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(0), sample)["params"])
    port = set_model(**dims, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    ans_list = [f"a{i}" for i in range(root["ans_dim"])]
    pds = set_dataset(*args, is_train=True, dataset_type="vqa")
    for n in (0, 2):
        logs = ListLogger(), ListLogger()
        got = sample_vqa(port, Loader(pds, 5), ans_list, logger=logs[0],
                         sample=n)
        want = jax_sample_vqa(jm, params, JaxLoader(jds, 5, prefetch=0),
                              ans_list, logger=logs[1], sample=n)
        assert got == want
        assert sum(got.values()) == (len(pds) if n == 0 else 10)
        assert logs[0].lines == logs[1].lines
        assert len(logs[0].lines) == (5 if n == 0 else 2)


def test_reference_state_dict_loads_for_val(workdir, tmp_path, monkeypatch):
    """A bare state_dict saved with torch.save loads through --load_model
    for val and scores as the port's own checkpoint of the same weights;
    it does not resume training."""
    _, root = workdir
    monkeypatch.chdir(tmp_path)
    flags = ["--mode", "val", "--comment", "ref", "--predictor_type", "q-cap",
             "--decoder_type", "none"]
    args = parse_args(common_args(root, flags))
    port = set_model(encoder_type="base", predictor_type="q-cap",
                     decoder_type="none", ntoken=root["ntoken"],
                     v_dim=root["v_dim"], embed_dim=EMBED, hidden_dim=HIDDEN,
                     ans_dim=root["ans_dim"], att_type=args.att_type,
                     generator=torch.Generator().manual_seed(4), device="cpu")
    own, bare = str(tmp_path / "own.ckpt"), str(tmp_path / "epoch_3.pt")
    state = TrainState(port, make_optimizer(port, lr=1e-3))
    ckpt.save_checkpoint(own, state, epoch=0)
    torch.save(port.state_dict(), bare)
    scores = []
    for path in (own, bare):
        port_main.main(common_args(root, flags + ["--load_model", path]))
        scores.append(np.load(tmp_path / "checkpoint" / "ref" / "valid"
                              / "scores.npy"))
    np.testing.assert_array_equal(scores[0], scores[1])
    assert ckpt.load_params(bare).keys() == port.state_dict().keys()
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt.load_checkpoint(bare, state)


def test_restore_params_fills_only_the_gcn_convs():
    """A relation model takes a state_dict without its GCN convs (as a
    reference file comes): the convs keep the model's values, the rest
    loads; a missing parameter outside the convs, or an unknown key,
    raises and names it."""
    dims = dict(encoder_type="relation", predictor_type="q-cap",
                decoder_type="none", ntoken=50, v_dim=V_DIM, embed_dim=EMBED,
                hidden_dim=HIDDEN, ans_dim=ANS, att_type="new", conv_layer=1)
    src = set_model(**dims, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    dst = set_model(**dims, generator=torch.Generator().manual_seed(2),
                    device="cpu")
    fresh = {k: v.clone() for k, v in dst.state_dict().items()}
    sd = {k: v for k, v in src.state_dict().items() if ".conv" not in k}
    convs = [k for k in fresh if k not in sd]
    assert convs and all(k.startswith("encoder.spatial_encoder.conv0.")
                         for k in convs)
    ckpt.restore_params(dst, sd)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, fresh[k] if k in convs else sd[k]), k
    with pytest.raises(KeyError, match="predictor.cls_net.main.0.weight"):
        ckpt.restore_params(dst, {k: v for k, v in sd.items()
                                  if k != "predictor.cls_net.main.0.weight"})
    with pytest.raises(KeyError, match="predictor.extra"):
        ckpt.restore_params(dst, dict(sd, **{"predictor.extra": torch.ones(1)}))
