"""The port's host library (vqa_tpu_torch/data/native.py over
csrc/host/vqa_native.cpp) against vqa_tpu.native, and the port's packed
store and Loader over it against vqa_tpu.data.

Every comparison is exact: the gathers move bytes, the f16 widening is IEEE
(both libraries convert the same way), the densify writes min(count, 3) / 3
in f32, and the spatial labels are small integers from the same double
arithmetic. The library is built with g++ into build/host/; without g++ the
tests skip, as tests/test_native.py does.
"""

import filecmp
import os

import numpy as np
import pytest

from vqa_tpu import native as jax_native
from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.data.relation import relation_graphs_batched as jax_graphs_batched
from vqa_tpu.data.shards import pack_feature_dir as jax_pack
from vqa_tpu.data.synthetic import make_synthetic_root as jax_make_root
from vqa_tpu_torch.data import native
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.shards import PackedFeatures, pack_feature_dir, quantize_features
from vqa_tpu_torch.data.tokenizer import soft_answer_scores

ROOT_KW = dict(split="train2014", num_images=7, num_questions=41, num_objs=6,
               v_dim=24, vocab_size=30, num_answers=11, q_len=7, c_len=12,
               seed=8)
STORE_FILES = ("_features.npy", "_scales.npy", "_bbox.npy", "_graphs.npy",
               "_index.json")


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("host library unavailable (g++ build failed)")
    if not jax_native.available():
        pytest.skip("vqa_tpu's native library unavailable")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native_root"))
    jax_make_root(path, **ROOT_KW)
    return path


def test_the_library_is_built_from_the_port_into_build_host():
    """The port builds its own copy of the source into build/host/ and never
    touches native/."""
    lib = native.build()
    assert lib.parent.name == "host" and lib.parent.parent.name == "build"
    assert native.SOURCE.parts[-3:] == ("csrc", "host", "vqa_native.cpp")
    assert "native" not in lib.parent.parts[-3:]


def test_the_cuda_build_hashes_files_beside_the_host_directory(monkeypatch,
                                                              tmp_path):
    """csrc/host/ lives beside the CUDA sources: the CUDA build hashes the
    files of csrc/ and steps over the directory, so without nvcc it raises
    its own KernelBuildError (not IsADirectoryError)."""
    from vqa_tpu_torch.ops.kernels import _build
    assert (_build.CSRC / "host").is_dir()

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")
    monkeypatch.setattr(_build, "_find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(_build.KernelBuildError):
        _build.build()


@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.float16, np.uint8])
def test_gather_bytes_equal_jax(rng, dtype):
    # every bit pattern, NaNs included: the gathers move bytes
    src = rng.integers(0, 256, (50, 12, 7 * np.dtype(dtype).itemsize),
                       dtype=np.uint8).view(dtype)
    rows = rng.integers(-50, 50, 33)          # negative indices, as numpy's
    got = native.gather_rows(src, rows, widen_f16=False)
    want = jax_native.gather_rows(src, np.where(rows < 0, rows + 50, rows),
                                  widen_f16=False)
    assert got.dtype == want.dtype == dtype and got.flags["C_CONTIGUOUS"]
    assert got.tobytes() == want.tobytes() == src[rows].tobytes()


def test_gather_refuses_rows_out_of_range(rng):
    src = rng.standard_normal((5, 3)).astype(np.float32)
    for rows in ([0, 5], [-6]):
        with pytest.raises(IndexError):
            native.gather_rows(src, np.asarray(rows))


def test_f16_widening_equals_jax_with_special_values(rng):
    """Zeros of both signs, infinities, a NaN, subnormals, the largest half
    and rows long enough for the F16C loop and its scalar tail."""
    special = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 6.1e-5, 5.96e-8,
                          -5.96e-8, 65504.0, -65504.0, 1.5], np.float16)
    src = (rng.standard_normal((9, 3, 13)) * 100).astype(np.float16)
    src[2, 1, :len(special)] = special
    rows = np.asarray([2, 0, 8, 2])
    got = native.gather_rows(src, rows, widen_f16=True)
    want = jax_native.gather_rows(src, rows, widen_f16=True)
    assert got.dtype == np.float32
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert got.tobytes() == src[rows].astype(np.float32).tobytes()


def test_densify_equals_jax_and_the_python_loop(rng):
    dicts = [{str(int(k)): int(c) for k, c in zip(
        rng.choice(40, rng.integers(0, 6), replace=False), rng.integers(1, 9, 6))}
        for _ in range(200)] + [{}, {"0": 3, "39": 1}]
    got = native.densify_answers_native(dicts, 40)
    want = jax_native.densify_answers_native(dicts, 40)
    python = np.asarray([soft_answer_scores(d, 40) for d in dicts], np.float32)
    assert got.dtype == np.float32 and got.shape == (len(dicts), 40)
    assert got.tobytes() == want.tobytes() == python.tobytes()
    assert native.densify_answers_native([], 40).shape == (0, 40)
    with pytest.raises(IndexError):
        native.densify_answers_native([{"40": 1}], 40)


def test_spatial_graphs_equal_jax(rng):
    """The native labels equal the JAX library's and both packages' numpy
    graph functions, on boxes with the reference's edge cases."""
    xy = rng.random((5, 11, 2)) * 300
    wh = rng.random((5, 11, 2)) * 120 + 5
    bbox = np.concatenate([xy, xy + wh], axis=-1)
    bbox[0, 1] = bbox[0, 0] + [10, 10, -10, -10]     # inside box 0
    bbox[0, 2] = bbox[0, 0]                          # equal to box 0
    bbox[1, 3] = bbox[1, 4] + [5, 5, 5, 5]           # overlaps box 4
    w = rng.random(5) * 400 + 200
    h = rng.random(5) * 300 + 200
    got = native.spatial_relation_graphs_native(bbox, w, h)
    want = jax_native.spatial_relation_graphs_native(bbox, w, h)
    assert got.dtype == np.int8 and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, jax_graphs_batched(bbox, w, h))
    assert {1, 2, 3} <= set(np.unique(got))
    with pytest.raises(ValueError):
        native.spatial_relation_graphs_native(bbox, w[:4], h)


@pytest.mark.parametrize("threads", ["1", "3", "16"])
def test_one_thread_against_many(rng, monkeypatch, threads):
    """VQA_NATIVE_THREADS sets the worker count; every count gives the same
    bytes as the default."""
    src = rng.integers(-127, 128, (300, 4, 64)).astype(np.int8)
    src16 = rng.standard_normal((300, 4, 64)).astype(np.float16)
    rows = rng.integers(0, 300, 257)
    dicts = [{"1": 2, "5": 4}] * 97
    default = (native.gather_rows(src, rows), native.gather_rows(src16, rows),
               native.densify_answers_native(dicts, 8))
    monkeypatch.setenv("VQA_NATIVE_THREADS", threads)
    assert native.threads() == int(threads)
    got = (native.gather_rows(src, rows), native.gather_rows(src16, rows),
           native.densify_answers_native(dicts, 8))
    for g, d in zip(got, default):
        assert g.tobytes() == d.tobytes()
    monkeypatch.delenv("VQA_NATIVE_THREADS")
    assert native.threads() == min(32, os.cpu_count() or 1)


def test_routes_are_counted_and_a_strided_source_takes_numpy(rng, monkeypatch):
    """A source that is not C-contiguous goes through numpy fancy indexing
    (as in JAX); without the library every entry point falls back; ROUTES
    says which route each call took."""
    src = rng.standard_normal((20, 6, 8)).astype(np.float16)
    view = src[:, ::2]
    rows = rng.integers(0, 20, 9)
    native.reset_routes()
    got = native.gather_rows(view, rows)
    assert native.ROUTES == {"native": 0, "fallback": 1}
    want = jax_native.gather_rows(view, rows)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    native.gather_rows(src, rows)
    assert native.ROUTES == {"native": 1, "fallback": 1}
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    np.testing.assert_array_equal(native.gather_rows(src, rows),
                                  src[rows].astype(np.float32))
    assert native.densify_answers_native([{"1": 1}], 3) is None
    assert native.spatial_relation_graphs_native(np.zeros((1, 2, 4)), [1.0],
                                                 [1.0]) is None
    assert native.ROUTES == {"native": 1, "fallback": 4}


@pytest.mark.parametrize("feature_dtype", [np.float16, np.int8])
def test_pack_feature_dir_writes_jax_files(tmp_path, root, feature_dtype):
    """The port's packer writes the JAX package's files byte for byte (f16,
    int8 with scales, bbox, graphs, index), and the store holds what
    quantize_features gives."""
    feat_dir = os.path.join(root, "features", "train2014")
    graph_dir = os.path.join(root, "graphs", "train2014")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_pack(feat_dir, str(tmp_path / "jax" / "s"), feature_dtype=feature_dtype,
             graph_dir=graph_dir)
    store = pack_feature_dir(feat_dir, str(tmp_path / "port" / "s"),
                             feature_dtype=feature_dtype, graph_dir=graph_dir)
    written = sorted(os.listdir(tmp_path / "port"))
    assert written == sorted(os.listdir(tmp_path / "jax"))
    assert written == sorted("s" + f for f in STORE_FILES
                             if f != "_scales.npy" or feature_dtype == np.int8)
    for name in written:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    names = sorted(os.listdir(feat_dir))
    first = np.load(os.path.join(feat_dir, names[3]))
    np.testing.assert_array_equal(store.bbox[store.row(names[3])], first["bbox"])
    if feature_dtype == np.int8:
        q, s = quantize_features(first["x"][None])
        np.testing.assert_array_equal(store.features[3], q[0])
        np.testing.assert_array_equal(store.scales[3], s[0])
    with pytest.raises(ValueError):
        pack_feature_dir(str(tmp_path / "port"), str(tmp_path / "none"))


@pytest.mark.parametrize("feature_dtype,feature_mode", [
    (np.float16, "float32"), (np.float16, "int8"), (np.int8, "int8"),
    (np.int8, "float32")])
def test_packed_loader_batches_equal_jax(tmp_path, root, feature_dtype,
                                         feature_mode):
    """Through both packages' native routes, a packed store (f16 or int8,
    with graphs) gives the same Loader batches key by key: the vqa set,
    the int8 feed and the graphs; the port's feed took the native route."""
    feat_dir = os.path.join(root, "features", "train2014")
    graphs = os.path.join(root, "graphs")
    out = tmp_path / "features"
    out.mkdir()
    pack_feature_dir(feat_dir, str(out / "train2014"), feature_dtype=feature_dtype,
                     graph_dir=os.path.join(graphs, "train2014"))
    args = (os.path.join(root, "annot"), str(out), ROOT_KW["num_answers"])
    kw = dict(graph_path=graphs, is_train=True, dataset_type="vqa",
              feature_mode=feature_mode)
    native.reset_routes()
    got = list(Loader(set_dataset(*args, **kw), 8, shuffle=True, seed=4))
    assert native.ROUTES["native"] > 0 and native.ROUTES["fallback"] == 0
    want = list(JaxLoader(jax_set_dataset(*args, **kw), 8, shuffle=True, seed=4))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
            assert np.asarray(g[key]).tobytes() == np.asarray(w[key]).tobytes(), key
    assert {"graph", "a", "q"} <= set(got[0])
    assert ("img_q" in got[0]) == (feature_mode == "int8")


def test_packed_store_reads_like_numpy(tmp_path, root, monkeypatch):
    """The native gathers of a packed store give the bytes of the numpy
    routes they replace (the same store read with the library off)."""
    feat_dir = os.path.join(root, "features", "train2014")
    pack_feature_dir(feat_dir, str(tmp_path / "s"), feature_dtype=np.float16,
                     graph_dir=os.path.join(root, "graphs", "train2014"))
    store = PackedFeatures(str(tmp_path / "s"))
    rows = np.asarray([6, 0, 3, 3, 1])
    fast = (store.gather(rows), *store.gather_quantized(rows),
            store.gather_graphs(rows), store.gather(rows, dtype=np.float16))
    monkeypatch.setattr(native, "_load", lambda: None)
    plain = (store.gather(rows), *store.gather_quantized(rows),
             store.gather_graphs(rows), store.gather(rows, dtype=np.float16))
    for f, p in zip(fast, plain):
        assert f.dtype == p.dtype and f.tobytes() == p.tobytes()
    assert fast[0].dtype == np.float32 and fast[4].dtype == np.float16


def test_concurrent_gathers_count_every_route(rng):
    """More Python threads than cores gathering at once (each call running
    the library's own threads), with a short switch interval: every result
    is right and ROUTES loses no count."""
    import sys
    import threading
    src = rng.integers(-127, 128, (64, 3, 40)).astype(np.int8)
    rows = [rng.integers(0, 64, 17) for _ in range(24)]
    errors = []

    def work(i):
        for _ in range(20):
            if native.gather_rows(src, rows[i]).tobytes() != src[rows[i]].tobytes():
                errors.append(i)
    native.reset_routes()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(i,)) for i in range(24)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers) and not errors
    assert native.ROUTES == {"native": 24 * 20, "fallback": 0}
