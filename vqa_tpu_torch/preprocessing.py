"""Offline dataset preparation CLI of the port
(``python -m vqa_tpu_torch.preprocessing``), the counterpart of the
repository's root ``preprocessing.py``: the same flags (``type=bool`` parsing
included, kept on purpose as ``vqa_tpu_torch/config.py`` keeps it) and the
same artifacts.

Port of the reference's ``preprocessing.py:44-253``: VQA v2 JSON ->
tokenized / padded questions, soft-score answer dicts, answer-type index,
COCO caption tokens grouped by image — same output JSON schemas. Additions
beyond the reference (all optional flags):

- ``--save_graph``: builds the spatial-relation graphs from bbox npz features
  (the reference required an out-of-repo step; SURVEY.md section 3.4) with
  the port's vectorized ``relation_graphs_batched``.
- ``--pack_features``: converts the per-image npz directory into a packed
  memory-mapped store for the feed (``data/shards.py`` ``pack_feature_dir``).
- the answer-type index is written once, as JSON, and read as JSON
  (fixes the reference's index.pkl/answer_type.json mismatch,
  SURVEY.md section 2.1 defect 10).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from vqa_tpu_torch.data.relation import relation_graphs_batched
from vqa_tpu_torch.data.shards import pack_feature_dir
from vqa_tpu_torch.data.tokenizer import Vocab, get_tokens, padding


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--vqa_path", type=str, default="../annot/VQA_annotations")
    parser.add_argument("--coco_path", type=str, default="../annot/annotations")
    parser.add_argument("--vocab_path", type=str, default="../data/vocab_list.txt")
    parser.add_argument("--ans_vocab_path", type=str,
                        default="../data/answer_candidate.txt")
    parser.add_argument("--feature_path", type=str, default="../COCO_feature_36")
    parser.add_argument("--dataset_type", type=str, default="train2014")
    parser.add_argument("--save_path", type=str, default="../annot")
    parser.add_argument("--c_len", type=int, default=20)
    parser.add_argument("--q_len", type=int, default=10)
    parser.add_argument("--save_q", type=bool, default=False)
    parser.add_argument("--save_a", type=bool, default=False)
    parser.add_argument("--save_c", type=bool, default=False)
    parser.add_argument("--save_graph", type=bool, default=False)
    parser.add_argument("--graph_path", type=str, default="../COCO_graph_36")
    parser.add_argument("--pack_features", type=bool, default=False)
    parser.add_argument("--pack_path", type=str, default="")
    parser.add_argument("--glove_path", type=str, default="")
    return parser.parse_args(argv)


def preprocessing(vqa_path: str,
                  coco_path: str,
                  vocab_path: str,
                  ans_vocab_path: str,
                  feature_path: str,
                  dataset_type: str,
                  save_path: str = "annot",
                  c_len: int = 20,
                  q_len: int = 10,
                  save_q: bool = False,
                  save_a: bool = False,
                  save_c: bool = False):
    """VQA/COCO JSON -> preprocessed artifacts (reference preprocessing.py:44-233)."""
    os.makedirs(save_path, exist_ok=True)
    vocab = Vocab.load(vocab_path)
    with open(ans_vocab_path, encoding="utf-8") as f:
        ans_list = f.read().split("\n")
    ans_index = {a: i for i, a in enumerate(ans_list)}

    def save_file(file_name, desc, data_type, data):
        with open(file_name, "w") as f:
            f.write(json.dumps({"description": desc, "data_type": data_type,
                                "data": data}))

    # ---------------- answers (preprocessing.py:141-170)
    with open(os.path.join(vqa_path,
                           f"v2_mscoco_{dataset_type}_annotations.json")) as f:
        a_json = json.load(f)["annotations"]
    a_data = []
    ans_type = {"yes/no": [], "number": [], "other": []}
    for i in range(len(a_json)):
        ans_type[a_json[i]["answer_type"]].append(i)
        if save_a:
            answers = [a["answer"] for a in a_json[i]["answers"]]
            ans_dict = {}
            for a in set(answers):
                if a in ans_index:
                    ans_dict[ans_index[a]] = answers.count(a)
            a_data.append(ans_dict)
    if save_a:
        save_file(os.path.join(save_path, f"{dataset_type}_answers.json"),
                  "This is VQA v2.0 answers dataset.", dataset_type, a_data)
        with open(os.path.join(save_path,
                               f"{dataset_type}_answer_type.json"), "w") as f:
            f.write(json.dumps(ans_type))
        # canonical eval index (one format; SURVEY.md 2.1 #10)
        with open(os.path.join(save_path, "index.json"), "w") as f:
            f.write(json.dumps(ans_type))

    # ---------------- questions (preprocessing.py:175-200)
    with open(os.path.join(
            vqa_path, f"v2_OpenEnded_mscoco_{dataset_type}_questions.json")) as f:
        q_json = json.load(f)["questions"]
    q_data = []
    for q in q_json:
        if save_q:
            words, tokens = get_tokens(q["question"], vocab)
            tokens, _ = padding(tokens, q_len, vocab.pad)
            q_data.append({
                "img_file": f"COCO_{dataset_type}_"
                            f"{str(q['image_id']).zfill(12)}.npz",
                "q_word": words,
                "q": tokens,
            })
    if save_q:
        save_file(os.path.join(save_path, f"{dataset_type}_questions.json"),
                  "This is VQA v2.0 questions dataset.", dataset_type, q_data)

    # ---------------- captions (preprocessing.py:204-231)
    if save_c:
        with open(os.path.join(coco_path,
                               f"captions_{dataset_type}.json")) as f:
            c_json = json.load(f)["annotations"]
        captions = {}
        for c in c_json:
            captions.setdefault(c["image_id"], []).append(c["caption"])
        cap_token = {}
        for image_id in captions:
            entry = {"c_word": [], "c": [], "cap_len": []}
            for caption in captions[image_id]:
                words, tokens = get_tokens(caption, vocab, is_cap=True)
                tokens, cap_len = padding(tokens, c_len, vocab.pad)
                entry["c_word"].append(words)
                entry["c"].append(tokens)
                entry["cap_len"].append(cap_len)
            cap_token[image_id] = entry
        save_file(os.path.join(save_path, f"{dataset_type}_captions.json"),
                  "This is COCO Captions dataset.", dataset_type, cap_token)
        # grouped-by-image variant used by the 'all'/'select' datasets
        with open(os.path.join(save_path,
                               f"{dataset_type}_all_captions.json"), "w") as f:
            f.write(json.dumps({str(k): v for k, v in cap_token.items()}))


def load_image_sizes(coco_json_path: str):
    """image id -> (width, height) from a COCO annotation JSON's ``images``
    section (captions_*.json and instances_*.json both carry it)."""
    with open(coco_json_path) as f:
        images = json.load(f).get("images", [])
    return {int(im["id"]): (float(im["width"]), float(im["height"]))
            for im in images if "width" in im and "height" in im}


def _image_id_from_npz(name: str) -> int:
    """COCO_{split}_{12-digit id}.npz -> image id."""
    return int(name.rsplit("_", 1)[-1].split(".")[0])


def build_graphs(feature_dir: str, graph_dir: str, chunk: int = 256,
                 image_sizes=None):
    """Spatial-relation graphs from bbox npz (replaces the out-of-repo step,
    reference util/relation.py:65-79).

    ``image_sizes``: {image_id: (w, h)} from the COCO annotation JSON
    (``load_image_sizes``) — the reference's offline step used the real
    image dimensions, and the ``dist <= 0.5*diag`` threshold
    (util/relation.py:36-38) is sensitive to them. Images missing from the
    map (or a None map) fall back to the bbox extent (max x1 / max y1) as a
    proxy; with real sizes the output matches reference-preprocessed
    ``COCO_graph_36`` exactly.
    """
    os.makedirs(graph_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(feature_dir) if f.endswith(".npz"))
    for start in range(0, len(names), chunk):
        batch_names = names[start:start + chunk]
        bboxes = np.stack([np.load(os.path.join(feature_dir, n))["bbox"]
                           for n in batch_names])
        w = bboxes[:, :, 2].max(axis=1)
        h = bboxes[:, :, 3].max(axis=1)
        if image_sizes:
            for i, n in enumerate(batch_names):
                size = image_sizes.get(_image_id_from_npz(n))
                if size is not None:
                    w[i], h[i] = size
        graphs = relation_graphs_batched(bboxes, w, h)
        for i, n in enumerate(batch_names):
            np.savez(os.path.join(graph_dir, n),
                     graph=graphs[i].astype(np.float64))


def main(argv=None) -> None:
    """The CLI: the artifacts the flags ask for (the root script's
    ``__main__`` block)."""
    args = parse_args(argv)
    preprocessing(
        vqa_path=args.vqa_path, coco_path=args.coco_path,
        vocab_path=args.vocab_path, ans_vocab_path=args.ans_vocab_path,
        feature_path=args.feature_path, dataset_type=args.dataset_type,
        save_path=args.save_path, c_len=args.c_len, q_len=args.q_len,
        save_q=args.save_q, save_a=args.save_a, save_c=args.save_c,
    )
    feat_dir = os.path.join(args.feature_path, args.dataset_type)
    if args.save_graph:
        sizes = None
        coco_json = os.path.join(args.coco_path,
                                 f"captions_{args.dataset_type}.json")
        if os.path.exists(coco_json):
            sizes = load_image_sizes(coco_json)
        build_graphs(feat_dir, os.path.join(args.graph_path, args.dataset_type),
                     image_sizes=sizes)
    if args.pack_features:
        out_prefix = os.path.join(args.pack_path or args.feature_path,
                                  args.dataset_type)
        pack_feature_dir(feat_dir, out_prefix,
                         graph_dir=os.path.join(args.graph_path,
                                                args.dataset_type)
                         if args.save_graph else None)


if __name__ == "__main__":
    main()
