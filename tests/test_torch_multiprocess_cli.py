"""The port's entry point under several processes: ``python -m
vqa_tpu_torch.main`` as 2 gloo ranks on the CPU (the ``VQA_TPU_MULTIHOST``
variables), beside the same flags in one process, over one synthetic
mini-split with a small MTL model (VQA head and BUTD caption decoder).

- ``--mode train`` then ``--mode val`` with ``--n_model_shards 2`` (the
  heads sliced over both ranks) write one set of artifacts (rank 0's), and
  the validation scores equal the single-process run's;
- ``--mode decode`` over 2 data ranks writes one ``decode.txt``, one
  caption per val question in dataset order, equal to one process's
  decode of the same checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.parallel.dryrun import free_port, wait_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL_QUESTIONS = 11


def flags(root, comment, mode, extra=()):
    return ["--vocab_path", root["vocab_path"], "--ans_path", root["ans_path"],
            "--load_path", root["annot"], "--feature_path",
            root["feature_root"], "--select_path", "vqa-e",
            "--pretrained_embed_path", "", "--embed_dim", "16",
            "--hidden_dim", "24", "--decoder_hidden_dim", "24",
            "--v_dim", str(root["v_dim"]), "--c_len", str(root["c_len"]),
            "--predictor_type", "base", "--decoder_type", "butd",
            "--use_mtl", "1", "--batch_size", "4", "--epoches", "1",
            "--device", "cpu", "--comment", comment, "--mode", mode,
            *extra]


def start(args, cwd, world=1):
    """``python -m vqa_tpu_torch.main args`` in ``world`` processes."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        if world > 1:
            env.update(VQA_TPU_MULTIHOST="1", VQA_TPU_COORD=f"localhost:{port}",
                       VQA_TPU_NPROCS=str(world), VQA_TPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vqa_tpu_torch.main"] + args, cwd=str(cwd),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def finish(procs):
    outs = wait_ranks(procs, 300)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def score_lines(out):
    return [line for line in out.splitlines() if line.startswith("hparam/")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("mp_cli")
    root = make_synthetic_root(str(cwd), num_images=6, num_questions=24)
    make_synthetic_root(str(cwd), split="val2014", num_images=4,
                        num_questions=VAL_QUESTIONS, seed=9)
    tp = ["--n_model_shards", "2"]
    single, tp_train, _ = finish(
        start(flags(root, "single", "train"), cwd)
        + start(flags(root, "tp", "train", tp), cwd, world=2))
    trained = sorted(os.listdir(cwd / "checkpoint" / "tp"))
    best = str(cwd / "checkpoint" / "tp" / "best_model.ckpt")
    finish(start(flags(root, "decode1", "decode",
                                     ["--load_model", best]), cwd))
    tp_val = finish(start(flags(root, "tp", "val", tp), cwd, world=2))
    finish(start(flags(root, "tp", "decode"), cwd, world=2))
    return {"cwd": cwd, "single": single, "tp_train": tp_train,
            "tp_val": tp_val, "trained": trained}


def test_tp_train_and_val_write_one_set_of_artifacts(runs):
    names = runs["trained"]          # after the 2-rank training run
    assert sum(n.endswith("_log.txt") for n in names) == 1, names
    assert sorted(n for n in names if not n.endswith("_log.txt")) == [
        "best_model.ckpt", "epoch_0.ckpt", "param.pkl", "param.txt",
        "scalars.jsonl", "valid"], names
    with open(runs["cwd"] / "checkpoint" / "tp" / "scalars.jsonl") as f:
        evals = [line for line in f if '"train/eval"' in line]
    assert len(evals) == 1        # one writer: rank 0's
    # rank 0 alone prints the scores; both ranks took part
    assert len(score_lines(runs["tp_val"][1])) == 0
    assert any("backend gloo" in line for line in runs["tp_val"][1].splitlines())


def test_tp_val_score_equals_one_process(runs):
    cp = runs["cwd"] / "checkpoint"
    got = np.load(cp / "tp" / "valid" / "scores.npy")
    want = np.load(cp / "single" / "valid" / "scores.npy")
    assert got.shape == (VAL_QUESTIONS,)
    np.testing.assert_array_equal(got, want)
    assert score_lines(runs["tp_val"][0]) == score_lines(runs["single"]) != []
    assert score_lines(runs["tp_train"]) == score_lines(runs["single"])


def test_two_rank_decode_writes_one_file_in_dataset_order(runs):
    cp = runs["cwd"] / "checkpoint"
    got = (cp / "tp" / "decode.txt").read_text().split("\n")
    want = (cp / "decode1" / "decode.txt").read_text().split("\n")
    assert len(got) == VAL_QUESTIONS + 1 and got[-1] == ""
    assert got == want
