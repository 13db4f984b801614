"""int8 feature quantization and the packed-shard feature store
(counterpart of ``vqa_tpu/data/shards.py`` ``quantize_features`` and
``PackedFeatures``).

A packed store is ``<prefix>_features.npy`` [N, num_objs, v_dim] (float16,
or int8 with per-box scales in ``<prefix>_scales.npy``), optional
``<prefix>_bbox.npy`` and ``<prefix>_graphs.npy`` [N, num_objs, num_objs]
int8 relation labels, and ``<prefix>_index.json`` {img_file: row}. Gathers
are numpy fancy indexing over the memory map: the JAX package's threaded
native gather is a speed path that gives the same bytes.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


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
        return np.asarray(self.features[np.asarray(rows)]).astype(dtype)

    def gather_quantized(self, rows: np.ndarray):
        """int8 payload + per-box scales: an int8 store's own, or a float
        store's batch quantized here."""
        rows = np.asarray(rows)
        if self.features.dtype == np.int8:
            if self.scales is None:
                raise ValueError("int8 store without scales")
            return (np.asarray(self.features[rows]),
                    np.asarray(self.scales[rows], np.float32))
        return quantize_features(
            np.asarray(self.features[rows]).astype(np.float32))

    def gather_graphs(self, rows: np.ndarray) -> np.ndarray:
        """[batch] row ids -> [batch, num_objs, num_objs] stored labels."""
        if self.graphs is None:
            raise ValueError("no packed graphs at this prefix")
        return np.asarray(self.graphs[np.asarray(rows)])
