"""The port's parallel layer in one process against vqa_tpu's.

- ``param_shardings``: the parameters and dimensions it shards along
  ``model``, by the converted names of vqa_tpu's ``param_shardings``
  (tools/convert.py), for the MTL, ReGAT and q-cap models at a ``model``
  axis of 2, and of 3, where some dimensions do not divide;
- the Loader's process shards (``num_shards=3``): the same ids a shard,
  wrap-padding included, and the same lengths as vqa_tpu's;
- ``split_microbatches``, ``pipeline_apply`` on a 4-stage mesh (vqa_tpu's
  on 4 virtual CPU devices), and ``TwoStagePipeline`` against vqa_tpu's and
  against the unpipelined ``forward_cap`` at f32, 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.loader import Loader as JaxLoader
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.parallel import pipeline as jax_pipeline
from vqa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vqa_tpu.parallel.mesh import param_shardings as jax_param_shardings
from vqa_tpu.tools.import_torch import import_reference_state_dict
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.parallel import pipeline
from vqa_tpu_torch.parallel.mesh import param_shardings
from vqa_tpu_torch.tools.convert import (
    flax_to_state_dict, gcn_params_from_state_dict)

DIMS = dict(ntoken=40, v_dim=32, embed_dim=12, hidden_dim=24,
            decoder_hidden_dim=24, ans_dim=10, c_len=7, dropout=0.0,
            att_dropout=0.0, att_type="new")
MODELS = {
    "mtl": dict(encoder_type="base", predictor_type="base",
                decoder_type="butd", use_mtl=True),
    "regat": dict(encoder_type="relation", predictor_type="base",
                  decoder_type="none", conv_type="corr", conv_layer=1),
    "qcap": dict(encoder_type="base", predictor_type="q-cap",
                 decoder_type="butd", use_mtl=True),
}


def port_and_params(model: str, **over):
    """The port's seeded model and its weights as vqa_tpu's params."""
    port = set_model(**{**DIMS, **over}, **MODELS[model], device="cpu",
                     generator=torch.Generator().manual_seed(0))
    gcn, rest = gcn_params_from_state_dict(port.state_dict())
    params, unmapped = import_reference_state_dict(rest)
    assert not unmapped, unmapped

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            else:
                dst[k] = v

    merge(params, gcn)
    return port, params


def jax_layout(params, n_model: int):
    """vqa_tpu's shardings as {torch name: sharded dim or None}: each leaf
    sharded along axis a is replaced by values that vary along a alone,
    converted, and the varying dimension read back."""
    mesh = jax_make_mesh(n_data=1, n_model=n_model,
                         devices=jax.devices()[:n_model])
    shardings = jax_param_shardings(mesh, params)

    def mark(leaf, sharding):
        shape = np.shape(leaf)
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            return np.zeros(shape, np.float32)
        a = axes[0]
        ramp = np.arange(1, shape[a] + 1, dtype=np.float32).reshape(
            [-1 if i == a else 1 for i in range(len(shape))])
        return np.broadcast_to(ramp, shape).copy()

    marked = flax_to_state_dict(jax.tree_util.tree_map(mark, params,
                                                       shardings))
    out = {}
    for name, t in marked.items():
        varying = [d for d in range(t.dim())
                   if not torch.equal(t.amax(dim=d), t.amin(dim=d))]
        out[name] = varying[0] if varying else None
    return out


@pytest.mark.parametrize("n_model", [2, 3])
@pytest.mark.parametrize("model", list(MODELS))
def test_param_shardings_match_jax(model, n_model):
    port, params = port_and_params(model)
    got = param_shardings(port, n_model)
    want = jax_layout(params, n_model)
    assert got == want
    sharded = {k for k, v in got.items() if v is not None}
    if n_model == 2:        # every head dimension divides by 2
        heads = {"mtl": "generator.h2_fcnet.weight",
                 "regat": "predictor.classifier.main.3.weight_v",
                 "qcap": "predictor.cls_net.main.0.weight"}
        assert heads[model] in sharded
    else:                   # 10 answers and 40 tokens do not divide by 3
        assert "predictor.classifier.main.3.weight_v" not in sharded
        assert "generator.h2_fcnet.weight" not in sharded
        if model != "qcap":  # the classifier's 48-wide middle layer does
            assert "predictor.classifier.main.0.weight_v" in sharded


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("par")),
                               num_images=5, num_questions=23)


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_match_jax(root, shuffle):
    """Three shards of 23 questions: the ids of each batch (wrap-padding
    and the tail's repeats included), ``nvalid``, ``len`` and
    ``num_samples`` equal vqa_tpu's."""
    args = (root["annot"], root["feature_root"], root["ans_dim"])
    kw = dict(is_train=True, dataset_type="vqa")
    ours, theirs = set_dataset(*args, **kw), jax_set_dataset(*args, **kw)
    for shard in range(3):
        a = Loader(ours, 4, shuffle=shuffle, seed=9, num_shards=3,
                   shard_id=shard)
        b = JaxLoader(theirs, 4, shuffle=shuffle, seed=9, num_shards=3,
                      shard_id=shard)
        assert (len(a), a.num_samples, a.shard_length) == \
            (len(b), b.num_samples, b.shard_length) == (2, 8, 8)
        got = [(x["id"].tolist(), int(x["nvalid"])) for x in a]
        want = [(x["id"].tolist(), int(x["nvalid"])) for x in b]
        assert got == want


def test_loader_refuses_buckets_with_shards_and_shards_by_process(root):
    ds = set_dataset(root["annot"], root["feature_root"], root["ans_dim"],
                     is_train=True, dataset_type="vqa-e")
    with pytest.raises(ValueError, match="length_bucket"):
        Loader(ds, 4, num_shards=2, shard_id=1, length_bucket=True)
    with pytest.raises(ValueError, match="shard 2 of 2"):
        Loader(ds, 4, num_shards=2, shard_id=2)
    whole = Loader.for_process(ds, 4)    # no process group: one shard
    assert (whole.num_shards, whole.shard_id) == (1, 0)


def test_split_microbatches_matches_jax():
    rng = np.random.default_rng(0)
    batch = {"img": rng.standard_normal((8, 3, 4)).astype(np.float32),
             "q": rng.integers(0, 9, (8, 5)), "nvalid": np.int32(7)}
    got = pipeline.split_microbatches(batch, 4)
    want = jax_pipeline.split_microbatches(batch, 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    tensors = pipeline.split_microbatches(
        {k: torch.as_tensor(v) for k, v in batch.items()}, 2)
    assert tensors[1]["q"].shape == (4, 5) and int(tensors[1]["nvalid"]) == 7
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.split_microbatches(batch, 3)


def test_pipeline_apply_matches_jax_and_sequential():
    """4 stages, 6 microbatches (M + S - 1 = 9 ticks): the port on 4 CPU
    stages equals its own stage-by-stage product exactly and vqa_tpu's
    shard_map pipeline on 4 virtual devices."""
    S, M, mb, d = 4, 6, 8, 16
    rng = np.random.default_rng(0)
    w = rng.standard_normal((S, d, d)).astype(np.float32) * 0.3
    xs = rng.standard_normal((M, mb, d)).astype(np.float32)
    devices = pipeline.make_stage_mesh(S, ["cpu"] * S)
    got = pipeline.pipeline_apply(
        devices, lambda p, x: torch.relu(x @ p["w"]),
        {"w": torch.from_numpy(w)}, torch.from_numpy(xs))
    want = torch.from_numpy(xs)
    for s in range(S):
        want = torch.relu(want @ torch.from_numpy(w[s]))
    assert torch.equal(got, want)
    theirs = jax_pipeline.pipeline_apply(
        jax_pipeline.make_stage_mesh(S), lambda p, x: jax.nn.relu(x @ p),
        jnp.asarray(w), jnp.asarray(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="4 stages"):
        pipeline.make_stage_mesh(4, ["cpu"] * 3)


def test_two_stage_pipeline_matches_jax_and_forward_cap():
    """The BUTD caption model's encoder and generator as two stages over 4
    microbatches: the logits equal the unpipelined forward_cap's and
    vqa_tpu's TwoStagePipeline's (f32, 1e-5 relative)."""
    port, params = port_and_params("mtl", dropout=0.0)
    rng = np.random.default_rng(3)
    bsz, objs = 16, 5
    batch = {"img": rng.standard_normal((bsz, objs, DIMS["v_dim"])
                                        ).astype(np.float32),
             "q": rng.integers(0, DIMS["ntoken"], (bsz, 5)).astype(np.int32),
             "c": rng.integers(0, DIMS["ntoken"] - 1,
                               (bsz, DIMS["c_len"])).astype(np.int32),
             "cap_len": rng.integers(2, DIMS["c_len"] + 1, bsz
                                     ).astype(np.int32),
             "nvalid": np.int32(bsz)}
    micro = pipeline.split_microbatches(batch, 4)
    port.eval()
    with torch.inference_mode():
        want = port.forward_cap({k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items() if k != "nvalid"})
    pipe = pipeline.TwoStagePipeline(port, "cpu", "cpu")
    got = torch.cat([o["predict"] for o in pipe.run(micro)])
    np.testing.assert_allclose(got.numpy(), want["predict"].numpy(),
                               rtol=1e-5, atol=1e-6)
    jm = jax_set_model(**DIMS, **MODELS["mtl"])
    jpipe = jax_pipeline.TwoStagePipeline(
        jm, jax.tree_util.tree_map(jnp.asarray, params), jax.devices()[0],
        jax.devices()[-1])
    theirs = np.concatenate([np.asarray(o["predict"])
                             for o in jpipe.run([{k: jnp.asarray(v)
                                                  for k, v in m.items()
                                                  if k != "nvalid"}
                                                 for m in micro])])
    np.testing.assert_allclose(got.numpy(), theirs, rtol=1e-5, atol=1e-6)
