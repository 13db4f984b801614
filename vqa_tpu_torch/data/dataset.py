"""Datasets over the preprocessed VQA v2 + COCO Captions files (counterpart
of ``vqa_tpu/data/dataset.py``).

Four variants, keyed as the reference keys them:

- ``vqa``    VQADataset           (q, a, img)
- ``vqa-e``  VQAEDataset          (+ one explanation caption per QA)
- ``all``    VQACaptionAllDataset (5x size: every COCO caption; its
             ``get_batch_all`` gives all of a question's captions at once)
- ``select`` VQACaptionDataset    (one caption per QA via a selection pickle)

``get_batch(indices)`` returns a dict of stacked fixed-shape numpy arrays;
with ``feature_mode="int8"`` the features come as ``img_q`` int8 with
per-box ``img_scale``. With a ``graph_path`` the batches carry the spatial
relation labels ``graph`` [B, num_objs, num_objs] int32: from per-image
``.npz`` files (key ``graph``) beside npz features, or from the packed
store's ``<prefix>_graphs.npy``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Sequence

import numpy as np

from vqa_tpu_torch.data import native
from vqa_tpu_torch.data.shards import PackedFeatures, quantize_features
from vqa_tpu_torch.data.tokenizer import soft_answer_scores


def _load_json_data(path: str):
    with open(path) as f:
        return json.load(f)["data"]


class _NpzFeatures:
    """One ``.npz`` per image (key ``x``, and key ``graph`` in the graph
    directory), the reference's layout."""

    def __init__(self, feature_dir: str, graph_dir: str = ""):
        self.feature_dir = feature_dir
        self.graph_dir = graph_dir

    def batch(self, img_files: Sequence[str], want_graph: bool,
              quantized: bool = False):
        feats = [np.load(os.path.join(self.feature_dir, name))["x"]
                 for name in img_files]
        stacked = np.asarray(np.stack(feats), dtype=np.float32)
        if quantized:
            q, scales = quantize_features(stacked)
            out = {"img_q": q, "img_scale": scales}
        else:
            out = {"img": stacked}
        if want_graph:
            out["graph"] = np.stack(
                [np.load(os.path.join(self.graph_dir, name))["graph"]
                 for name in img_files]).astype(np.int32)
        return out


class _PackedBackend:
    """Packed shards: one vectorized gather per batch."""

    def __init__(self, prefix: str):
        self.packed = PackedFeatures(prefix)

    def batch(self, img_files: Sequence[str], want_graph: bool,
              quantized: bool = False):
        rows = np.asarray([self.packed.row(f) for f in img_files])
        if quantized:
            q, scales = self.packed.gather_quantized(rows)
            out = {"img_q": q, "img_scale": scales}
        else:
            out = {"img": self.packed.gather(rows)}
        if want_graph:
            out["graph"] = self.packed.gather_graphs(rows).astype(np.int32)
        return out


def _make_backend(feature_path: str, graph_path: str):
    if os.path.exists(feature_path + "_index.json"):
        return _PackedBackend(feature_path)
    return _NpzFeatures(feature_path, graph_path)


class VQADataset:
    """VQA questions + soft-score answers + image features."""

    def __init__(self, load_path: str, feature_path: str, dataset_name: str,
                 ans_dim: int, graph_path: str = "", caption_id_path: str = "",
                 feature_mode: str = "float32"):
        del caption_id_path
        self.questions = _load_json_data(f"{load_path}_questions.json")
        self.answers = _load_json_data(f"{load_path}_answers.json")
        self.ans_dim = ans_dim
        self.use_graph = graph_path != ""
        self.backend = _make_backend(feature_path, graph_path)
        self.dataset_name = dataset_name
        self.feature_mode = feature_mode
        self.q_tokens = np.asarray([q["q"] for q in self.questions], np.int32)
        self.img_files = [q["img_file"] for q in self.questions]

    def __len__(self) -> int:
        return len(self.questions)

    def load_answers(self, indices: Sequence[int]) -> np.ndarray:
        """Dense soft scores min(count, 3) / 3, [batch, ans_dim] f32, by the
        host library's scatter (the Python loop without the library)."""
        dicts = [self.answers[i] for i in indices]
        out = native.densify_answers_native(dicts, self.ans_dim)
        if out is not None:
            return out
        return np.asarray([soft_answer_scores(d, self.ans_dim) for d in dicts],
                          np.float32)

    def _vqa_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        files = [self.img_files[i] for i in indices]
        out = self.backend.batch(files, self.use_graph,
                                 quantized=self.feature_mode == "int8")
        out["id"] = np.asarray(indices, np.int32)
        out["q"] = self.q_tokens[np.asarray(indices)]
        out["a"] = self.load_answers(indices)
        return out

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        return self._vqa_batch(indices)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        """One sample: ``get_batch([index])`` without its batch axis."""
        return {k: v[0] for k, v in self.get_batch([index]).items()}


class VQAEDataset(VQADataset):
    """VQA-E: one explanation caption per QA pair."""

    def __init__(self, load_path, feature_path, dataset_name, ans_dim,
                 graph_path="", caption_id_path="", feature_mode="float32"):
        super().__init__(load_path, feature_path, dataset_name, ans_dim,
                         graph_path, feature_mode=feature_mode)
        caps = _load_json_data(f"{load_path}_captions.json")
        self.c_tokens = np.asarray([c["c"] for c in caps], np.int32)
        self.cap_lens = np.asarray([c["cap_len"] for c in caps], np.int32)

    def get_batch(self, indices):
        out = self._vqa_batch(indices)
        idx = np.asarray(indices)
        out["c"] = self.c_tokens[idx]
        out["cap_len"] = self.cap_lens[idx]
        return out


class VQACaptionAllDataset(VQADataset):
    """All 5 COCO captions per question, 5x the dataset size:
    ``vqa_index = i % len(questions)``, ``cap_index = i // len(questions)``."""

    def __init__(self, load_path, feature_path, dataset_name, ans_dim,
                 graph_path="", caption_id_path="", feature_mode="float32"):
        super().__init__(load_path, feature_path, dataset_name, ans_dim,
                         graph_path, feature_mode=feature_mode)
        with open(f"{load_path}_all_captions.json") as f:
            self.captions = json.load(f)
        self.img_ids = [str(int(f[-16:-4])) for f in self.img_files]
        self._cap_lens = None

    def __len__(self):
        return 5 * len(self.questions)

    def _caption_for(self, vqa_index: int, cap_index: int):
        entry = self.captions[self.img_ids[vqa_index]]
        return entry["c"][cap_index], entry["cap_len"][cap_index]

    def _caption_index(self, i: int):
        n = len(self.questions)
        return i % n, i // n

    def get_batch(self, indices):
        pairs = [self._caption_index(i) for i in indices]
        out = self._vqa_batch([v for v, _ in pairs])
        caps = [self._caption_for(v, c) for v, c in pairs]
        out["c"] = np.asarray([c[0] for c in caps], np.int32)
        out["cap_len"] = np.asarray([c[1] for c in caps], np.int32)
        return out

    def get_batch_all(self, indices):
        """Every candidate caption of each question, the max-relevance
        training feed (``training/select.py``): ``c_all`` [B, n_cap, c_len]
        and ``cap_len_all`` [B, n_cap]. ``indices`` are question indices."""
        out = self._vqa_batch(indices)
        entries = [self.captions[self.img_ids[i]] for i in indices]
        out["c_all"] = np.asarray([e["c"] for e in entries], np.int32)
        out["cap_len_all"] = np.asarray([e["cap_len"] for e in entries],
                                        np.int32)
        return out

    @property
    def cap_lens(self) -> np.ndarray:
        """Per-index caption lengths, for the length-bucketing loader."""
        if self._cap_lens is None:
            self._cap_lens = np.asarray(
                [self._caption_for(*self._caption_index(i))[1]
                 for i in range(len(self))], np.int32)
        return self._cap_lens


class VQACaptionDataset(VQACaptionAllDataset):
    """One selected caption per QA pair via the selection pickle."""

    def __init__(self, load_path, feature_path, dataset_name, ans_dim,
                 graph_path="", caption_id_path="", feature_mode="float32"):
        super().__init__(load_path, feature_path, dataset_name, ans_dim,
                         graph_path, feature_mode=feature_mode)
        with open(caption_id_path, "rb") as f:
            self.caption_id = pickle.load(f)

    def __len__(self):
        return len(self.questions)

    def _caption_index(self, i: int):
        return i, self.caption_id[i]


def set_dataset(load_path: str, feature_path: str, ans_dim: int,
                caption_id_path: str = "", graph_path: str = "",
                is_train: bool = False, is_val: bool = False,
                dataset_type: str = "select", feature_mode: str = "float32"):
    """Dataset factory with ``vqa_tpu``'s arguments."""
    if is_train:
        dataset_name = "train2014"
    elif is_val:
        dataset_name = "val2014"
    else:
        raise ValueError("set is_train or is_val")
    cls = {"vqa": VQADataset, "select": VQACaptionDataset,
           "all": VQACaptionAllDataset, "vqa-e": VQAEDataset}[dataset_type]
    return cls(load_path=os.path.join(load_path, dataset_name),
               feature_path=os.path.join(feature_path, dataset_name),
               dataset_name=dataset_name, ans_dim=ans_dim,
               graph_path=(os.path.join(graph_path, dataset_name)
                           if graph_path else ""),
               caption_id_path=caption_id_path, feature_mode=feature_mode)
