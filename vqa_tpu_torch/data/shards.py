"""int8 feature quantization and the packed-shard feature store
(counterpart of ``vqa_tpu/data/shards.py``).

A packed store is ``<prefix>_features.npy`` [N, num_objs, v_dim] (float16,
or int8 with per-box scales in ``<prefix>_scales.npy`` [N, num_objs]
float32), optional ``<prefix>_bbox.npy`` [N, num_objs, 4] float32 and
``<prefix>_graphs.npy`` [N, num_objs, num_objs] int8 relation labels, and
``<prefix>_index.json`` {img_file: row}. :func:`pack_feature_dir` writes one
from a directory of per-image ``.npz`` files. Batches are gathered from the
memory maps by the host library's threads (``data/native.py``): f16 rows
widened to f32 natively, an int8 payload gathered raw.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np

from vqa_tpu_torch.data import native


def quantize_features(x: np.ndarray):
    """Symmetric per-box int8 quantization: [N, num_objs, v_dim] float ->
    (int8 payload, [N, num_objs] float32 scales). The inverse is the
    encoder's ``img_q * img_scale``."""
    x = np.asarray(x, np.float32)
    scales = np.maximum(np.abs(x).max(axis=-1) / 127.0, 1e-8)
    q = np.clip(np.rint(x / scales[..., None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


class PackedFeatures:
    """Memory-mapped packed feature store with O(1) per-image row lookup."""

    def __init__(self, prefix: str):
        with open(prefix + "_index.json") as f:
            self.index: Dict[str, int] = json.load(f)
        self.features = np.load(prefix + "_features.npy", mmap_mode="r")
        bbox_path = prefix + "_bbox.npy"
        self.bbox = (np.load(bbox_path, mmap_mode="r")
                     if os.path.exists(bbox_path) else None)
        scales_path = prefix + "_scales.npy"
        self.scales = (np.load(scales_path, mmap_mode="r")
                       if os.path.exists(scales_path) else None)
        graph_path = prefix + "_graphs.npy"
        self.graphs = (np.load(graph_path, mmap_mode="r")
                       if os.path.exists(graph_path) else None)

    def row(self, img_file: str) -> int:
        return self.index[img_file]

    def gather(self, rows: np.ndarray, dtype=np.float32) -> np.ndarray:
        """[batch] row ids -> [batch, num_objs, v_dim] features (an int8
        store is dequantized)."""
        if self.features.dtype == np.int8:
            q, scales = self.gather_quantized(rows)
            return (q.astype(np.float32)
                    * scales[..., None].astype(np.float32)).astype(dtype)
        out = native.gather_rows(self.features, np.asarray(rows),
                                 widen_f16=(dtype == np.float32))
        return out if out.dtype == dtype else out.astype(dtype)

    def gather_quantized(self, rows: np.ndarray):
        """int8 payload + per-box scales: an int8 store's own, or a float
        store's batch quantized here."""
        rows = np.asarray(rows)
        if self.features.dtype == np.int8:
            if self.scales is None:
                raise ValueError("int8 store without scales")
            return (native.gather_rows(self.features, rows, widen_f16=False),
                    np.asarray(self.scales[rows], np.float32))
        return quantize_features(
            native.gather_rows(self.features, rows, widen_f16=True))

    def gather_graphs(self, rows: np.ndarray) -> np.ndarray:
        """[batch] row ids -> [batch, num_objs, num_objs] stored labels."""
        if self.graphs is None:
            raise ValueError("no packed graphs at this prefix")
        return native.gather_rows(self.graphs, np.asarray(rows),
                                  widen_f16=False)


def pack_feature_dir(feature_dir: str, out_prefix: str,
                     files: Optional[Iterable[str]] = None,
                     feature_dtype=np.float16,
                     graph_dir: Optional[str] = None) -> PackedFeatures:
    """Pack a directory of per-image ``.npz`` files (key ``x`` [num_objs,
    v_dim], and ``bbox`` [num_objs, 4] where the first file has it) into a
    store at ``out_prefix``: features in ``feature_dtype`` (float16, or int8
    with the per-box scales of :func:`quantize_features`), and the relation
    labels (key ``graph``) of the same names in ``graph_dir`` where given.
    ``files`` picks and orders the images (default: every ``.npz``, sorted);
    the index maps each to its row."""
    names = sorted(files) if files is not None else sorted(
        f for f in os.listdir(feature_dir) if f.endswith(".npz"))
    if not names:
        raise ValueError(f"no npz files in {feature_dir}")
    with np.load(os.path.join(feature_dir, names[0])) as first:
        num_objs, v_dim = first["x"].shape
        has_bbox = "bbox" in first

    def open_array(suffix: str, dtype, shape):
        return np.lib.format.open_memmap(out_prefix + suffix, mode="w+",
                                         dtype=dtype, shape=shape)

    quantize = np.dtype(feature_dtype) == np.int8
    n = len(names)
    feats = open_array("_features.npy", feature_dtype, (n, num_objs, v_dim))
    scales = (open_array("_scales.npy", np.float32, (n, num_objs))
              if quantize else None)
    bbox = (open_array("_bbox.npy", np.float32, (n, num_objs, 4))
            if has_bbox else None)
    graphs = (open_array("_graphs.npy", np.int8, (n, num_objs, num_objs))
              if graph_dir else None)
    index = {}
    for i, name in enumerate(names):
        with np.load(os.path.join(feature_dir, name)) as z:
            if quantize:
                feats[i], scales[i] = quantize_features(z["x"])
            else:
                feats[i] = z["x"].astype(feature_dtype)
            if bbox is not None:
                bbox[i] = z["bbox"]
        if graphs is not None:
            with np.load(os.path.join(graph_dir, name)) as g:
                graphs[i] = g["graph"]
        index[name] = i
    for array in (feats, scales, bbox, graphs):
        if array is not None:
            array.flush()
    with open(out_prefix + "_index.json", "w") as f:
        json.dump(index, f)
    return PackedFeatures(out_prefix)
