"""The port's own entry points for preparing data and scoring captions
(``python -m vqa_tpu_torch.preprocessing``, ``python -m
vqa_tpu_torch.cap_eval``) against the repository's root scripts, in
process, on a synthetic root.

Both preprocessors run on the same raw VQA v2 / COCO JSON with every
artifact flag on (questions, answers, captions, spatial graphs with the
images' real sizes, packed shards): the JSON files and the packed shards
must be byte-equal; the graph ``.npz`` files must hold byte-equal members
(the zip container stamps each member with the time it was written). Both
scorers read the same ``decode.txt`` and must return the same score dict
and write the same ``eval_result.txt``.
"""

import json
import os
import runpy
import sys
import zipfile

import numpy as np
import pytest

import cap_eval as root_cap_eval
from vqa_tpu.data.synthetic import make_synthetic_root
from vqa_tpu_torch import cap_eval, preprocessing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = "train2014"
N_IMG, N_Q = 9, 23


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A synthetic root (features with boxes, vocab, answer list) and raw
    VQA v2 / COCO JSON over its images, made from a seed."""
    base = tmp_path_factory.mktemp("prep")
    root = make_synthetic_root(str(base / "root"), split=SPLIT, num_images=N_IMG,
                               num_questions=3, num_objs=7, v_dim=16,
                               vocab_size=40, num_answers=12, seed=11)
    rng = np.random.default_rng(12)
    words = [f"w{i}" for i in range(36)] + ["unknown", "dog's"]

    def text(n, punct=""):
        return " ".join(rng.choice(words, n)) + punct
    answers = [f"a{i}" for i in range(12)] + ["not a candidate"]
    annotations = {"annotations": [
        {"image_id": int(i % N_IMG) + 1,
         "answer_type": ["yes/no", "number", "other"][i % 3],
         "answers": [{"answer": str(rng.choice(answers))} for _ in range(10)]}
        for i in range(N_Q)]}
    questions = {"questions": [
        {"image_id": int(i % N_IMG) + 1,
         "question": text(rng.integers(3, 14), "?").capitalize()}
        for i in range(N_Q)]}
    captions = {
        "images": [{"id": i + 1, "width": 640 - 10 * i, "height": 480}
                   for i in range(N_IMG - 2)],     # two without a size
        "annotations": [{"image_id": int(i % N_IMG) + 1,
                         "caption": f' "{text(rng.integers(4, 25), ".")}"\n'}
                        for i in range(5 * N_IMG)]}
    vqa, coco = base / "vqa", base / "coco"
    vqa.mkdir()
    coco.mkdir()
    for path, data in ((vqa / f"v2_mscoco_{SPLIT}_annotations.json", annotations),
                       (vqa / f"v2_OpenEnded_mscoco_{SPLIT}_questions.json",
                        questions),
                       (coco / f"captions_{SPLIT}.json", captions)):
        with open(path, "w") as f:
            json.dump(data, f)
    return base, root


def _argv(base, root, out: str):
    return ["--vqa_path", str(base / "vqa"), "--coco_path", str(base / "coco"),
            "--vocab_path", root["vocab_path"], "--ans_vocab_path", root["ans_path"],
            "--feature_path", root["feature_root"], "--dataset_type", SPLIT,
            "--save_path", str(base / out / "annot"),
            "--graph_path", str(base / out / "graphs"),
            "--pack_path", str(base / out / "packed"),
            "--save_q", "1", "--save_a", "1", "--save_c", "1",
            "--save_graph", "1", "--pack_features", "1"]


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, n), top)
                  for d, _, names in os.walk(top) for n in names)


def test_preprocessing_writes_the_root_scripts_artifacts(raw, monkeypatch):
    base, root = raw
    for out in ("ref", "port"):         # neither script makes --pack_path
        (base / out / "packed").mkdir(parents=True)
    monkeypatch.setattr(sys, "argv", ["preprocessing.py"] + _argv(base, root, "ref"))
    runpy.run_path(os.path.join(REPO, "preprocessing.py"), run_name="__main__")
    preprocessing.main(_argv(base, root, "port"))

    ref, port = base / "ref", base / "port"
    names = _files(port)
    assert names == _files(ref)
    assert {os.path.join("annot", f"{SPLIT}_{kind}.json") for kind in (
        "questions", "answers", "answer_type", "captions", "all_captions")} \
        | {os.path.join("annot", "index.json")} <= set(names)
    assert sum(n.startswith("graphs") for n in names) == N_IMG
    assert {os.path.join("packed", SPLIT + s) for s in (
        "_features.npy", "_bbox.npy", "_graphs.npy", "_index.json")} <= set(names)
    for name in names:
        if name.endswith(".npz"):
            with zipfile.ZipFile(port / name) as p, zipfile.ZipFile(ref / name) as r:
                assert p.namelist() == r.namelist() == ["graph.npy"]
                assert p.read("graph.npy") == r.read("graph.npy"), name
        else:
            assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    with open(port / "annot" / f"{SPLIT}_answers.json") as f:
        assert any(json.load(f)["data"])            # answers were counted
    graphs = np.load(port / "packed" / f"{SPLIT}_graphs.npy")
    assert graphs.shape == (N_IMG, 7, 7) and graphs.max() > 3


def test_preprocessing_parses_bools_as_the_root_script():
    """``type=bool``: any non-empty value is True ("--save_q 0" too), kept
    so that one command line does the same in both."""
    args = preprocessing.parse_args(["--save_q", "0", "--save_a", ""])
    assert args.save_q is True and args.save_a is False
    assert args.save_graph is False and args.q_len == 10 and args.c_len == 20


@pytest.mark.parametrize("tables", [[], ["--synonym_path", "none",
                                         "--paraphrase_path", "none"]])
def test_cap_eval_returns_the_root_scripts_scores(tmp_path, monkeypatch, tables):
    rng = np.random.default_rng(13)
    words = "a man guy woman riding bike bicycle street road next to beside " \
            "the dog is standing stands <start>".split()

    def sentence():
        return " ".join(rng.choice(words, rng.integers(3, 12)))
    ref_path = tmp_path / "val2014_captions.json"
    data = [{"c_word": [sentence() for _ in range(5)] if i % 3 else sentence()}
            for i in range(30)]
    with open(ref_path, "w") as f:
        json.dump({"data": data}, f)
    decoded = "\n".join("<start> " + sentence() for _ in range(30)) + "\n"
    for exp in ("port", "ref"):
        (tmp_path / "checkpoint" / exp).mkdir(parents=True)
        (tmp_path / "checkpoint" / exp / "decode.txt").write_text(decoded)
    monkeypatch.chdir(tmp_path)
    got = cap_eval.main(["--load_ref", str(ref_path), "--load_path", "port", *tables])
    want = root_cap_eval.main(["--load_ref", str(ref_path), "--load_path", "ref",
                               *tables])
    assert got == want
    assert len(got) == 7 and all(np.isfinite(v) for v in got.values())
    assert (tmp_path / "checkpoint" / "port" / "eval_result.txt").read_bytes() == \
        (tmp_path / "checkpoint" / "ref" / "eval_result.txt").read_bytes()
