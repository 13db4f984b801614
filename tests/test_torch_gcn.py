"""The port's ReGAT graph convolutions (vqa_tpu_torch/ops/gcn.py and
ops/kernels/gcn_chain.py) against vqa_tpu's.

The same seeded numpy inputs and the same weights (the flax init, converted
by vqa_tpu_torch/tools/convert.py) go through both, in f32 on the CPU, where
JAX runs its gcn_chain_fused and int8 Pallas kernels in interpret mode and
the port's wrappers run their plain versions. The CUDA kernel is held
against the plain version by chip_smoke.py.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.ops.gcn import GCN as JaxGCN
from vqa_tpu.ops.gcn import label_bias_sum as jax_label_bias_sum
from vqa_tpu.ops.pallas.gcn_chain import gcn_chain_fused as jax_gcn_chain
from vqa_tpu_torch.ops.gcn import GCN, label_bias_sum
from vqa_tpu_torch.ops.kernels import _build, gcn_chain
from vqa_tpu_torch.tools.convert import flax_to_state_dict

B, N, D, L = 8, 36, 64, 12
# f32: the same f32 products summed in other orders (tests/test_full_parity.py)
TOL = dict(rtol=1e-4, atol=1e-5)
# Through the int8 projections: an f32 rounding difference in the layer
# input or in a weight-normed kernel can flip one quantized value by one
# step where it sits on a rounding midpoint (about 1e-5 of the values). A
# flip moves a projection by 1/127 of its row's scale times one weight, and
# the second corr layer's softmax carries it on: measured over 80 seeded
# cases at most 3.2e-4 of the output's largest value, so 1e-3 of it.
INT8_ATOL_REL = 1e-3


def chain_inputs(rng):
    out_self = rng.standard_normal((B, N, D)).astype(np.float32)
    proj = rng.standard_normal((B, N, D)).astype(np.float32)
    alpha = np.maximum(rng.standard_normal((B, N, N)), 0).astype(np.float32)
    graph = rng.integers(0, L, (B, N, N)).astype(np.int32)
    graph[0, 0, :L] = np.arange(L)         # every label, 0 included
    bias = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    return out_self, proj, alpha, graph, bias


def test_gcn_chain_plain_matches_pallas_f32(rng):
    """f32: the same products summed in other orders (TOL)."""
    args = chain_inputs(rng)
    want = jax_gcn_chain(*map(jnp.asarray, args), num_labels=L, block_b=4,
                         interpret=True)
    got = gcn_chain.gcn_chain_fused(*map(torch.from_numpy, args), num_labels=L)
    assert got.dtype == torch.float32 and got.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gcn_chain_plain_matches_pallas_bf16(rng):
    """bf16 operands, f32 sums, two roundings to bf16 (o, then out). Where
    two f32 sums of different order straddle a rounding point the values
    are one bf16 ulp (2**-8 relative) apart; an ulp of o, or of the
    softmaxed weights, moves each output by at most that share of the
    largest |o|. So 2**-7 of the value plus 2**-8 of the largest value."""
    args = [a.astype(ml_dtypes.bfloat16) if a.dtype == np.float32 else a
            for a in chain_inputs(rng)]
    want = jax_gcn_chain(*map(jnp.asarray, args), num_labels=L, block_b=8,
                         interpret=True)
    got = gcn_chain.gcn_chain_fused(
        *[torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a)
          for a in args], num_labels=L)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_gcn_chain_counts_label_zero(rng):
    """Label 0 counts: with proj, alpha and out_self zero, o is the bias
    sum alone, and bias row 0 enters once for every non-edge; the softmax
    over i of a zero matrix is 1/N, so out[i] = mean over j of o[j]."""
    graph = np.zeros((1, N, N), np.int32)
    graph[0, :, :3] = 5                        # 3 edges of label 5 per row
    bias = np.zeros((L, 4), np.float32)
    bias[0], bias[5] = 1.0, 10.0
    z = torch.zeros(1, N, 4)
    got = gcn_chain.gcn_chain_fused(z, z, torch.zeros(1, N, N),
                                    torch.from_numpy(graph),
                                    torch.from_numpy(bias), num_labels=L)
    np.testing.assert_allclose(got.numpy(), np.full((1, N, 4), 33.0 + 30.0))


def test_label_bias_sum_matches_jax(rng):
    graph = rng.integers(0, L, (B, N, N)).astype(np.int32)
    bias = rng.standard_normal((L, D)).astype(np.float32)
    got = label_bias_sum(torch.from_numpy(graph), torch.from_numpy(bias), L)
    want = jax_label_bias_sum(jnp.asarray(graph), jnp.asarray(bias), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    counts = gcn_chain.label_counts(torch.from_numpy(graph), L, torch.float32)
    assert counts.sum(-1).eq(N).all()


def twins(rng, conv_type, conv_layer, use_pallas=False, use_int8=False,
          dropout=0.5):
    """A vqa_tpu GCN with its init params and the port's with the same
    weights, and one input (feature [B, N, D], graph [B, N, N]). The
    features are scaled as tests/test_pallas.py scales them (attended
    features are small): at unit scale two corr layers drive the softmax
    logits into the hundreds, where f32 rounding is amplified past TOL."""
    feature = (rng.standard_normal((B, N, D)) * 0.3).astype(np.float32)
    graph = rng.integers(0, L, (B, N, N)).astype(np.int32)
    kw = dict(num_labels=L, conv_layer=conv_layer, conv_type=conv_type,
              dropout=dropout, use_pallas=use_pallas, use_int8=use_int8)
    jm = JaxGCN(D, **kw)
    params = jm.init(jax.random.key(2), jnp.asarray(feature),
                     jnp.asarray(graph))["params"]
    sd = flax_to_state_dict(
        {"spatial_encoder": jax.tree_util.tree_map(np.asarray, params)})
    port = GCN(D, D, **kw)
    port.load_state_dict({k[len("spatial_encoder."):]: v for k, v in sd.items()})
    return jm, params, port, feature, graph


@pytest.mark.parametrize("conv_type", ["base", "direct", "corr"])
@pytest.mark.parametrize("conv_layer", [1, 2])
@pytest.mark.parametrize("use_pallas,use_int8", [
    (False, False), (True, False), (False, True), (True, True)])
def test_gcn_inference_matches_jax(rng, conv_type, conv_layer, use_pallas,
                                   use_int8):
    """Inference, each conv type, 1 and 2 layers, the kernel route
    (``use_pallas``: JAX's gcn_chain_fused in interpret mode against the
    plain version) and the plain route, with the int8 projections on and
    off (INT8_ATOL_REL, see above; the base conv has no int8 projections)."""
    jm, params, port, feature, graph = twins(rng, conv_type, conv_layer,
                                             use_pallas, use_int8)
    want = jm.apply({"params": params}, jnp.asarray(feature),
                    jnp.asarray(graph))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(feature), torch.from_numpy(graph))
    want = np.asarray(want)
    tol = (dict(rtol=1e-4, atol=INT8_ATOL_REL * np.abs(want).max())
           if use_int8 and conv_type != "base" else TOL)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("conv_type", ["base", "direct", "corr"])
def test_gcn_training_form_matches_jax(rng, conv_type):
    """The training form (the reference-shaped DotProduct, float
    projections even with use_int8 and use_pallas) with dropout 0."""
    jm, params, port, feature, graph = twins(rng, conv_type, 2, True, True,
                                             dropout=0.0)
    want = jm.apply({"params": params}, jnp.asarray(feature),
                    jnp.asarray(graph), deterministic=False)
    got = port.train()(torch.from_numpy(feature), torch.from_numpy(graph))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gcn_need_alpha_matches_jax(rng, use_pallas):
    """``get_alpha``: the corr convs take the plain route even with
    ``use_pallas`` (the kernel forms no alpha) and return each layer's
    softmaxed correlation."""
    jm, params, port, feature, graph = twins(rng, "corr", 2, use_pallas)
    want, w_alphas = jm.apply({"params": params}, jnp.asarray(feature),
                              jnp.asarray(graph), True)
    with torch.no_grad():
        got, alphas = port.eval()(torch.from_numpy(feature),
                                  torch.from_numpy(graph), get_alpha=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(alphas) == len(w_alphas) == 2
    for a, w in zip(alphas, w_alphas):
        assert a.shape == (B, N, N)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_gcn_chain_on_other_devices_goes_to_the_kernel(monkeypatch, tmp_path):
    """A tensor that is not on the CPU goes to the kernel, which here cannot
    be built: the wrapper raises and counts no launch. Shapes the kernel
    does not take raise first."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    meta = dict(device="meta", dtype=torch.bfloat16)

    def call(n=N, labels=L, d=D):
        return gcn_chain.gcn_chain_fused(
            torch.empty(2, n, d, **meta), torch.empty(2, n, d, **meta),
            torch.empty(2, n, n, **meta),
            torch.empty(2, n, n, device="meta", dtype=torch.int32),
            torch.empty(labels, d, **meta), num_labels=labels)

    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        call()
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="N=36"):
        call(n=20)
    with pytest.raises(ValueError, match="16 labels"):
        call(labels=17)
    with pytest.raises(ValueError, match="multiple of 8"):
        call(d=100)


def _meta_chain(batch=2, n=N, d=D, labels=L, dtype=torch.bfloat16, offset=None):
    """gcn_chain_fused's operands on the meta device; ``offset`` = (name,
    bytes) starts that operand's data that many bytes into its storage."""
    def make(name, shape, dt):
        count = int(np.prod(shape))
        skip = offset[1] if offset and offset[0] == name else 0
        per = torch.empty((), dtype=dt).element_size()
        t = torch.empty(count + -(-skip // per), device="meta", dtype=dt)
        if skip:
            t = t.view(torch.int8)[skip:skip + count * per].view(dt)
        return t[:count].view(*shape)
    return (make("out_self", (batch, n, d), dtype), make("proj", (batch, n, d), dtype),
            make("alpha_raw", (batch, n, n), dtype),
            make("graph", (batch, n, n), torch.int32),
            make("bias", (labels, d), dtype))


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))


@pytest.mark.parametrize("case, kw, match", [
    ("N=20", dict(n=20), "N=36"),
    ("17 labels", dict(labels=17), "16 labels"),
    ("D=1004", dict(d=1004), "multiple of 8"),
    ("float16", dict(dtype=torch.float16), "float32 or bfloat16"),
    ("out_self align", dict(offset=("out_self", 8)), "16-byte"),
    ("proj align", dict(offset=("proj", 8)), "16-byte"),
    ("bias align", dict(offset=("bias", 8)), "16-byte"),
])
def test_gcn_chain_kernel_refuses_before_any_build(monkeypatch, tmp_path, case,
                                                   kw, match):
    """What the chain kernels cannot take raises before the library is
    built: another box count, more than 16 labels, a D that is not a whole
    number of 16-byte pieces, another type, and the TMA-read operands off a
    16-byte boundary."""
    _no_nvcc(monkeypatch, tmp_path)
    labels = kw.get("labels", L)
    with pytest.raises((ValueError, TypeError), match=match):
        gcn_chain.gcn_chain_fused(*_meta_chain(**kw), num_labels=labels)


@pytest.mark.parametrize("batch, d, labels, dtype", [
    (512, 2048, 12, torch.bfloat16), (8192, 2048, 12, torch.bfloat16),
    (1003, 1000, 12, torch.bfloat16), (1, 8, 16, torch.bfloat16),
    (3, 8200, 15, torch.bfloat16), (1003, 2048, 12, torch.float32)])
def test_shapes_the_chain_kernel_takes_reach_the_build(monkeypatch, tmp_path,
                                                      batch, d, labels, dtype):
    """The requests' B=512, the timed B=8192, a ragged B with a D that is
    not a whole number of 64-column tiles, the narrowest D, a D of more
    than one resident column group, and f32 pass every check of
    gcn_chain_fused and go to the build, which raises here (no nvcc) and
    counts no launch."""
    _no_nvcc(monkeypatch, tmp_path)
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        gcn_chain.gcn_chain_fused(*_meta_chain(batch, N, d, labels, dtype),
                                  num_labels=labels)
    assert _build.LAUNCHES == before
