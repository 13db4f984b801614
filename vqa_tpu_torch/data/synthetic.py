"""Synthetic dataset roots in the real on-disk layout (counterpart of
``vqa_tpu/data/synthetic.py`` ``make_synthetic_root``).

Writes ``annot/{split}_questions.json`` / ``_answers.json`` /
``_answer_type.json`` / ``_captions.json`` / ``_all_captions.json``, the
caption-selection pickle, ``index.json``, per-image feature ``.npz`` (keys
``x``, ``bbox``), per-image spatial-relation graph ``.npz`` (key ``graph``,
from the boxes in a 640 x 480 image) and the vocab / answer-candidate text
files, byte for byte as the JAX package writes them for the same seed.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from vqa_tpu_torch.data.relation import relation_graphs_batched


def make_synthetic_root(root: str,
                        split: str = "train2014",
                        num_images: int = 8,
                        num_questions: int = 32,
                        num_objs: int = 6,
                        v_dim: int = 32,
                        vocab_size: int = 40,
                        num_answers: int = 12,
                        q_len: int = 10,
                        c_len: int = 20,
                        seed: int = 0) -> dict:
    """Create a synthetic dataset under ``root``; returns the paths dict."""
    rng = np.random.default_rng(seed)
    annot = os.path.join(root, "annot")
    feat_dir = os.path.join(root, "features", split)
    graph_dir = os.path.join(root, "graphs", split)
    os.makedirs(annot, exist_ok=True)
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(graph_dir, exist_ok=True)

    # vocab: words w0..wN + specials; answers a0..aM
    words = [f"w{i}" for i in range(vocab_size - 4)] + \
        ["<oov>", "<start>", "<end>", "<pad>"]
    vocab_path = os.path.join(root, "vocab_list.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(words))
    ans_path = os.path.join(root, "answer_candidate.txt")
    with open(ans_path, "w") as f:
        f.write("\n".join(f"a{i}" for i in range(num_answers)))
    pad_id = len(words) - 1
    start_id = len(words) - 3
    end_id = len(words) - 2

    img_files = []
    bboxes = np.zeros((num_images, num_objs, 4))
    for i in range(num_images):
        name = f"COCO_{split}_{str(i + 1).zfill(12)}.npz"
        img_files.append(name)
        x = rng.standard_normal((num_objs, v_dim)).astype(np.float32)
        xy = rng.random((num_objs, 2)) * 400
        wh = rng.random((num_objs, 2)) * 100 + 10
        bbox = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
        bboxes[i] = bbox
        np.savez(os.path.join(feat_dir, name), x=x, bbox=bbox)
    graphs = relation_graphs_batched(bboxes, np.full(num_images, 640.0),
                                     np.full(num_images, 480.0))
    for i, name in enumerate(img_files):
        np.savez(os.path.join(graph_dir, name),
                 graph=graphs[i].astype(np.float64))

    q_data, a_data = [], []
    ans_type = {"yes/no": [], "number": [], "other": []}
    types = ["yes/no", "number", "other"]
    for i in range(num_questions):
        img = img_files[int(rng.integers(num_images))]
        toks = rng.integers(0, vocab_size - 4, size=int(rng.integers(3, q_len)))
        toks = list(map(int, toks)) + [pad_id] * (q_len - len(toks))
        q_data.append({"img_file": img, "q_word": "synthetic", "q": toks[:q_len]})
        n_ans = int(rng.integers(1, 4))
        a_data.append({str(int(a)): int(rng.integers(1, 6))
                       for a in rng.choice(num_answers, n_ans, replace=False)})
        ans_type[types[int(rng.integers(3))]].append(i)

    def save(name, data):
        with open(os.path.join(annot, f"{split}_{name}.json"), "w") as f:
            json.dump({"description": "synthetic", "data_type": split,
                       "data": data}, f)

    save("questions", q_data)
    save("answers", a_data)
    with open(os.path.join(annot, f"{split}_answer_type.json"), "w") as f:
        json.dump(ans_type, f)

    # captions: 1 per question (vqa-e) + 5 per image (all)
    def rand_caption():
        body = list(map(int, rng.integers(0, vocab_size - 4,
                                          size=int(rng.integers(3, c_len - 2)))))
        toks = [start_id] + body + [end_id]
        cap_len = min(len(toks), c_len)
        toks = (toks + [pad_id] * c_len)[:c_len]
        return toks, cap_len

    c_data = []
    for _ in range(num_questions):
        toks, cap_len = rand_caption()
        c_data.append({"c_word": "synthetic cap", "c": toks, "cap_len": cap_len})
    save("captions", c_data)

    all_caps = {}
    for name in img_files:
        img_id = str(int(name[-16:-4]))
        entry = {"c_word": [], "c": [], "cap_len": []}
        for _ in range(5):
            toks, cap_len = rand_caption()
            entry["c_word"].append("synthetic cap")
            entry["c"].append(toks)
            entry["cap_len"].append(cap_len)
        all_caps[img_id] = entry
    with open(os.path.join(annot, f"{split}_all_captions.json"), "w") as f:
        json.dump(all_caps, f)

    # one selection pickle shared across splits: merge keys, so a second
    # split's generation never shrinks the index range
    select_path = os.path.join(annot, "most_relevant.pkl")
    selection = {}
    if os.path.exists(select_path):
        with open(select_path, "rb") as f:
            selection = pickle.load(f)
    selection.update({i: int(rng.integers(5)) for i in range(num_questions)})
    with open(select_path, "wb") as f:
        pickle.dump(selection, f)

    index_path = os.path.join(annot, "index.json")
    with open(index_path, "w") as f:
        json.dump(ans_type, f)

    return {
        "annot": annot,
        "feature_root": os.path.join(root, "features"),
        "graph_root": os.path.join(root, "graphs"),
        "vocab_path": vocab_path,
        "ans_path": ans_path,
        "select_path": select_path,
        "index_path": index_path,
        "split": split,
        "ans_dim": num_answers,
        "ntoken": len(words),
        "v_dim": v_dim,
        "num_objs": num_objs,
        "q_len": q_len,
        "c_len": c_len,
    }
