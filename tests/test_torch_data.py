"""The port's host data layer (vqa_tpu_torch/data) against vqa_tpu/data.

The port keeps its own numpy-only copy of the synthetic root, the datasets
and the Loader; these tests hold it to the JAX package's: the same files for
the same seed, and the same batches, key by key, for the same root, seed and
batch size.
"""

import filecmp
import os
import pickle

import numpy as np
import pytest

from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.data.relation import relation_graph as jax_relation_graph
from vqa_tpu.data.relation import relation_graphs_batched as jax_graphs_batched
from vqa_tpu.data.shards import pack_feature_dir
from vqa_tpu.data.shards import quantize_features as jax_quantize
from vqa_tpu.data.synthetic import make_synthetic_root as jax_make_root
from vqa_tpu.data.tokenizer import Vocab as JaxVocab
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.relation import relation_graph, relation_graphs_batched
from vqa_tpu_torch.data.shards import quantize_features
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.data.tokenizer import Vocab

ROOT_KW = dict(split="train2014", num_images=6, num_questions=37, num_objs=5,
               v_dim=16, vocab_size=30, num_answers=9, q_len=7, c_len=12,
               seed=5)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic root made by each package."""
    jax_root = str(tmp_path_factory.mktemp("jax_root"))
    port_root = str(tmp_path_factory.mktemp("port_root"))
    jax_make_root(jax_root, **ROOT_KW)
    make_synthetic_root(port_root, **ROOT_KW)
    return jax_root, port_root


def test_synthetic_root_writes_the_same_files(roots):
    """Every question, answer, caption, feature, relation-graph, vocab and
    selection file is byte-equal, and the port writes no other."""
    jax_root, port_root = roots
    for dirpath, _, files in os.walk(port_root):
        rel = os.path.relpath(dirpath, port_root)
        for name in files:
            path = os.path.join(rel, name)
            if name.endswith(".pkl"):
                with open(os.path.join(jax_root, path), "rb") as f, \
                        open(os.path.join(port_root, path), "rb") as g:
                    assert pickle.load(f) == pickle.load(g), path
            else:
                assert filecmp.cmp(os.path.join(jax_root, path),
                                   os.path.join(port_root, path),
                                   shallow=False), path
    written = {os.path.relpath(os.path.join(d, n), jax_root)
               for d, _, fs in os.walk(jax_root) for n in fs}
    ported = {os.path.relpath(os.path.join(d, n), port_root)
              for d, _, fs in os.walk(port_root) for n in fs}
    assert ported == written
    assert any(p.startswith(os.path.join("annot", "train2014_captions")) for p in ported)
    assert any(p.startswith(os.path.join("graphs", "train2014")) for p in ported)


def test_quantize_and_vocab_match(rng, roots):
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[1, 2] = 0.0                       # an all-zero box: the 1e-8 floor
    for got, want in zip(quantize_features(x), jax_quantize(x)):
        np.testing.assert_array_equal(got, want)
    path = os.path.join(roots[1], "vocab_list.txt")
    port, ref = Vocab.load(path), JaxVocab.load(path)
    assert port.words == ref.words
    assert (port.start, port.end, port.pad, port.oov) == \
        (ref.start, ref.end, ref.pad, ref.oov)
    assert port.index("w3") == ref.index("w3") and port.index("zz") == ref.oov


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("dataset_type,feature_mode,loader_kw", [
    ("vqa", "int8", dict(shuffle=True, drop_last=True)),
    ("vqa-e", "int8", dict(shuffle=True, length_bucket=True,
                           bucket_bounds=(5, 8))),
    ("vqa-e", "float32", dict(shuffle=False, drop_last=False)),
    ("all", "int8", dict(shuffle=True, length_bucket=True)),
    ("select", "float32", dict(shuffle=True)),
])
def test_loader_batches_match(roots, dataset_type, feature_mode, loader_kw):
    """Both packages read the JAX package's root into the same batches, key
    by key: the shuffle, the padded tail, the caption-length buckets."""
    jax_root, _ = roots
    args = (os.path.join(jax_root, "annot"), os.path.join(jax_root, "features"),
            ROOT_KW["num_answers"])
    kw = dict(caption_id_path=os.path.join(jax_root, "annot", "most_relevant.pkl"),
              is_train=True, dataset_type=dataset_type,
              feature_mode=feature_mode)
    port_ds, jax_ds = set_dataset(*args, **kw), jax_set_dataset(*args, **kw)
    assert len(port_ds) == len(jax_ds)
    port_loader = Loader(port_ds, 8, seed=3, **loader_kw)
    jax_loader = JaxLoader(jax_ds, 8, seed=3, **loader_kw)
    assert len(port_loader) == len(jax_loader)
    for _ in range(2):                  # two epochs: the rng carries over
        _assert_same_batches(list(port_loader), list(jax_loader))


def test_packed_store_batches_match(tmp_path, roots):
    """A packed int8 store (written by the JAX package's packer) gives the
    same batches through the port's numpy gathers."""
    jax_root, _ = roots
    feat_dir = os.path.join(jax_root, "features", "train2014")
    out = tmp_path / "features"
    out.mkdir()
    pack_feature_dir(feat_dir, str(out / "train2014"), feature_dtype=np.int8)
    args = (os.path.join(jax_root, "annot"), str(out), ROOT_KW["num_answers"])
    for mode in ("int8", "float32"):
        kw = dict(is_train=True, dataset_type="vqa-e", feature_mode=mode)
        _assert_same_batches(list(Loader(set_dataset(*args, **kw), 16)),
                             list(JaxLoader(jax_set_dataset(*args, **kw), 16)))


def test_relation_graphs_match_jax(rng):
    """The port's copy of the relation builder: the batched labels equal
    JAX's, and each image's equal the per-pair loop of both packages, on
    boxes with the reference's edge cases (a box inside another, one box
    equal to another, overlapping and distant boxes)."""
    xy = rng.random((3, 9, 2)) * 300
    wh = rng.random((3, 9, 2)) * 120 + 5
    bbox = np.concatenate([xy, xy + wh], axis=-1)
    bbox[0, 1] = bbox[0, 0] + [10, 10, -10, -10]     # inside box 0
    bbox[0, 2] = bbox[0, 0]                          # equal to box 0
    bbox[1, 3] = bbox[1, 4] + [5, 5, 5, 5]           # overlaps box 4
    w, h = np.array([640.0, 500.0, 320.0]), np.array([480.0, 375.0, 240.0])
    got = relation_graphs_batched(bbox, w, h)
    want = jax_graphs_batched(bbox, w, h)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        np.testing.assert_array_equal(relation_graph(bbox[b], w[b], h[b]), got[b])
        np.testing.assert_array_equal(jax_relation_graph(bbox[b], w[b], h[b]), got[b])
    assert {1, 2, 3} <= set(np.unique(got)) and got.max() <= 11


@pytest.mark.parametrize("store,feature_mode", [
    ("npz", "int8"), ("npz", "float32"), ("packed", "int8")])
def test_graph_batches_match(tmp_path, roots, store, feature_mode):
    """With a graph_path both packages' batches carry the same ``graph``
    [B, objs, objs] int32 labels: from the per-image npz files, or from a
    packed store's ``_graphs.npy`` (written by the JAX package's packer)."""
    jax_root, _ = roots
    feat = os.path.join(jax_root, "features")
    graphs = os.path.join(jax_root, "graphs")
    if store == "packed":
        out = tmp_path / "features"
        out.mkdir()
        pack_feature_dir(os.path.join(feat, "train2014"), str(out / "train2014"),
                         feature_dtype=np.int8,
                         graph_dir=os.path.join(graphs, "train2014"))
        feat = str(out)
    args = (os.path.join(jax_root, "annot"), feat, ROOT_KW["num_answers"])
    kw = dict(graph_path=graphs, is_train=True, dataset_type="vqa",
              feature_mode=feature_mode)
    got = list(Loader(set_dataset(*args, **kw), 8, shuffle=True, seed=2))
    want = list(JaxLoader(jax_set_dataset(*args, **kw), 8, shuffle=True, seed=2))
    _assert_same_batches(got, want)
    n = ROOT_KW["num_objs"]
    assert all(b["graph"].shape == (8, n, n) and b["graph"].dtype == np.int32
               for b in got)
