"""The port's kernel modules (vqa_tpu_torch/ops/kernels) against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel run in interpret mode, as tests/test_pallas.py
runs it. The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vqa_tpu.ops.pallas.feed_gemm import dequant_matmul as jax_dequant_matmul
from vqa_tpu.ops.pallas.gru_v2 import gru_last_state_v2 as jax_gru_v2
from vqa_tpu.ops.pallas.lazyv_pool import pool_int8 as jax_pool_int8
from vqa_tpu.ops.pallas.vocab_topk import vocab_topk_lse as jax_vocab_topk_lse
from vqa_tpu_torch.ops.kernels import (
    _build, decode_att, feed_gemm, gcn_chain, gru_v2, lazyv_pool, vocab_topk)

BF16 = ml_dtypes.bfloat16
# One bf16 rounding of an f32 sum: two sums in different orders may land on
# neighbouring bf16 values, at most 2**-7 of the value apart.
BF16_RTOL = 2.0 ** -7


def bf16_pair(a: np.ndarray):
    """The same bf16 values as a jax array and a torch tensor."""
    a32 = a.astype(BF16).astype(np.float32)
    return jnp.asarray(a32, jnp.bfloat16), torch.from_numpy(a32).to(torch.bfloat16)


@pytest.mark.parametrize("batch", [16, 24])
def test_gru_v2_plain_matches_pallas(rng, batch):
    """bf16 operands, f32 state: both sides take exact bf16 products into f32
    sums, so only the sum order differs (rtol 1e-4, atol 1e-5 as
    tests/test_pallas.py)."""
    t_len, hidden = 6, 32
    xi_j, xi_t = bf16_pair(rng.standard_normal((batch, t_len, 3 * hidden)))
    wh_j, wh_t = bf16_pair(rng.standard_normal((hidden, 3 * hidden)) * 0.2)
    bh_j, bh_t = bf16_pair(rng.standard_normal(3 * hidden) * 0.2)
    want = jax_gru_v2(xi_j, wh_j, bh_j, tile_b=8, interpret=True)
    got = gru_v2.gru_last_state_v2(xi_t, wh_t, bh_t)
    assert got.dtype == torch.float32 and got.shape == (batch, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("rows", [96, 101])
def test_dequant_matmul_plain_matches_pallas(rng, rows):
    """Ragged M (101 rows, off the JAX kernel's 32-row tile). Both round
    x_q * scale to bf16 before an f32-accumulated GEMM."""
    k, n = 128, 32
    x_q = rng.integers(-127, 128, (rows, k)).astype(np.int8)
    xs_j, xs_t = bf16_pair(rng.random(rows) * 0.05 + 1e-3)
    w_j, w_t = bf16_pair(rng.standard_normal((k, n)) * 0.05)
    want = jax_dequant_matmul(jnp.asarray(x_q), xs_j, w_j, tile_m=32,
                              interpret=True)
    got = feed_gemm.dequant_matmul(torch.from_numpy(x_q), xs_t, w_t)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("objs, batch", [(36, 4), (10, 13), (36, 7)])
def test_dequant_matmul_gated_logits_plain_matches_pallas(rng, objs, batch):
    """The gated entry's plain version against the JAX package's
    composition: its dequant_matmul (interpret mode), the bias, the ReLU
    and the folded logit ``einsum("bnd,bd->bn")``, all in bf16. M = 144,
    130 and 252 rows: none a multiple of 128, none a whole number of
    128-row tiles of images. Each side rounds vp and the logit to bf16, in
    its own order: within bf16 rounding of the row's sum of |terms|."""
    k, n = 64, 48
    rows = batch * objs
    x_q = rng.integers(-127, 128, (rows, k)).astype(np.int8)
    xs_j, xs_t = bf16_pair(rng.random(rows) * 0.05 + 1e-3)
    w_j, w_t = bf16_pair(rng.standard_normal((k, n)) * 0.1)
    b_j, b_t = bf16_pair(rng.standard_normal(n) * 0.1)
    g_j, g_t = bf16_pair(rng.standard_normal((batch, n)))
    vp = jax_dequant_matmul(jnp.asarray(x_q), xs_j, w_j, tile_m=32,
                            interpret=True)
    vp = jnp.maximum(vp + b_j, 0).reshape(batch, objs, n)
    want = jnp.einsum("bnd,bd->bn", vp, g_j,
                      preferred_element_type=jnp.bfloat16).reshape(-1)
    got = feed_gemm.dequant_matmul_gated_logits(torch.from_numpy(x_q), xs_t,
                                                w_t, b_t, g_t, objs)
    assert got.dtype == torch.bfloat16 and got.shape == (rows,)
    scale = np.einsum("bnd,bd->bn", np.abs(np.asarray(vp, np.float32)),
                      np.abs(np.asarray(g_j, np.float32))).reshape(-1)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert np.all(diff <= 2 * BF16_RTOL * scale + 1e-6)


@pytest.mark.parametrize("objs", [36, 10])
def test_gated_logits_route_equals_the_unfused_attention(objs):
    """A bf16 serving encoder on the int8 feed (MultiplyAttention,
    use_pallas): its ``v_att``, ``v_w`` and ``v_sum`` through the gated
    route equal, bit for bit, those of the unfused module: the
    v-projection (``W_v`` of the dequantized features), bias and ReLU as
    vp, then the attention's folded logits
    and softmax over vp, then the pooling."""
    from vqa_tpu_torch.models.encoder import BaseEncoder
    from vqa_tpu_torch.ops.quant import dequantize

    gen = torch.Generator().manual_seed(5)
    enc = BaseEncoder(30, 48, 8, 32, att_type="new", use_pallas=True,
                      generator=gen).eval().to(torch.bfloat16)
    batch = {"q": torch.randint(0, 30, (7, 5), generator=gen),
             "img_q": torch.randint(-127, 128, (7, objs, 48), generator=gen,
                                    dtype=torch.int8),
             "img_scale": (torch.rand(7, objs, generator=gen) * 0.05
                           + 1e-3).to(torch.bfloat16)}
    launches = dict(_build.LAUNCHES)
    with torch.no_grad():
        out = enc(batch)
        q = enc.q_rnn(enc.embedding(batch["q"]))
        vp = enc.attention.W_v(dequantize(batch["img_q"], batch["img_scale"]))
        v_att = enc.attention(None, q, v_cache=vp)
    w = v_att[..., 0] * batch["img_scale"]
    assert torch.equal(out["v_att"], v_att)
    assert torch.equal(out["v_w"], w)
    assert torch.equal(out["v_sum"],
                       lazyv_pool.pool_int8_reference(w, batch["img_q"]))
    assert _build.LAUNCHES == launches


@pytest.mark.parametrize("batch", [16, 19])
def test_pool_int8_plain_matches_pallas(rng, batch):
    """Ragged B (19, off the JAX kernel's 8-row tile). The Pallas kernel sums
    in f32 and rounds once to bf16, as the port's bf16 einsum does."""
    objs, d = 6, 128
    x_q = rng.integers(-127, 128, (batch, objs, d)).astype(np.int8)
    w_j, w_t = bf16_pair(rng.random((batch, objs)) * 0.05)
    want = jax_pool_int8(w_j, jnp.asarray(x_q), tile_b=8, interpret=True)
    got = lazyv_pool.pool_int8(w_t, torch.from_numpy(x_q))
    assert got.dtype == torch.bfloat16 and got.shape == (batch, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_vocab_topk_lse_plain_matches_pallas(rng, dtype, k):
    """V=1000 against the Pallas kernel's 256-column chunks: the last chunk
    is ragged. Both take f32 sums of exact products and add the bias in
    f32; only the sum order differs (rtol 1e-5, atol 1e-5 as
    tests/test_tools.py). Columns 5/700 (other chunks) and 40/41 (one
    chunk) are duplicated with a large bias, so two exact ties lead every
    row: both sides must give the lower index first, as lax.top_k does."""
    rows, hidden, vocab = 64, 32, 1000
    h = rng.standard_normal((rows, hidden))
    w = rng.standard_normal((vocab, hidden)) * 0.1     # the port's [V, H]
    b = rng.standard_normal(vocab) * 0.1
    w[700], w[41] = w[5], w[40]
    b[5] = b[700] = 20.0
    b[40] = b[41] = 10.0
    if dtype == "bf16":
        (h_j, h_t), (w_j, w_t), (b_j, b_t) = map(bf16_pair, (h, w.T.copy(), b))
        w_t = w_t.t().contiguous()
    else:
        h_t, w_t, b_t = (torch.from_numpy(a.astype(np.float32)) for a in (h, w, b))
        h_j, w_j, b_j = (jnp.asarray(a.astype(np.float32)) for a in (h, w.T, b))
    want = jax_vocab_topk_lse(h_j, w_j, b_j, k=k, tile_r=32, tile_v=256,
                              interpret=True)
    vals, idx, lse = vocab_topk.vocab_topk_lse(h_t, w_t, b_t, k)
    assert (vals.dtype, idx.dtype, lse.dtype) == (torch.float32, torch.int32,
                                                 torch.float32)
    assert vals.shape == idx.shape == (rows, k) and lse.shape == (rows, 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.full(rows, 5))
    if k > 1:
        np.testing.assert_array_equal(idx[:, 1].numpy(), np.full(rows, 700))
    for got, ref in ((vals, want[0]), (lse, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_topk_first_breaks_ties_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 1.0]])
    vals, idx = vocab_topk.topk_first(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == [[3.0, 3.0, 3.0], [2.0, 2.0, 2.0]]


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the loader raises a clear error instead of returning None."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()


def test_non_cpu_tensors_go_to_the_kernel(monkeypatch, tmp_path):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel, which here cannot be built, so each wrapper raises (and
    counts no launch)."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    meta = dict(device="meta", dtype=torch.bfloat16)
    calls = [
        lambda: gru_v2.gru_last_state_v2(torch.empty(8, 3, 96, **meta),
                                         torch.empty(32, 96, **meta),
                                         torch.empty(96, **meta)),
        lambda: feed_gemm.dequant_matmul(
            torch.empty(10, 64, device="meta", dtype=torch.int8),
            torch.empty(10, **meta), torch.empty(64, 16, **meta)),
        lambda: lazyv_pool.pool_int8(
            torch.empty(4, 6, **meta),
            torch.empty(4, 6, 32, device="meta", dtype=torch.int8)),
        lambda: vocab_topk.vocab_topk_lse(torch.empty(9, 64, **meta),
                                          torch.empty(100, 64, **meta),
                                          torch.empty(100, **meta), 3),
    ]
    before = dict(_build.LAUNCHES)
    for call in calls:
        with pytest.raises(_build.KernelBuildError):
            call()
    assert _build.LAUNCHES == before


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """Shape and type checks run before any build or launch."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        gru_v2.gru_last_state_v2(torch.empty(8, 3, 60, **meta),
                                 torch.empty(20, 60, **meta),
                                 torch.empty(60, **meta))
    with pytest.raises(ValueError, match="multiple of 16"):
        feed_gemm.dequant_matmul(
            torch.empty(10, 40, device="meta", dtype=torch.int8),
            torch.empty(10, **meta), torch.empty(40, 16, **meta))
    with pytest.raises(ValueError, match="multiple of 16"):
        lazyv_pool.pool_int8(torch.empty(4, 6, **meta),
                             torch.empty(4, 6, 40, device="meta",
                                         dtype=torch.int8))
    with pytest.raises(TypeError, match="bfloat16"):
        lazyv_pool.pool_int8(torch.empty(4, 6, device="meta"),
                             torch.empty(4, 6, 32, device="meta",
                                         dtype=torch.int8))
    h, w, b = (torch.empty(9, 64, **meta), torch.empty(100, 64, **meta),
               torch.empty(100, **meta))
    with pytest.raises(ValueError, match="k=9"):
        vocab_topk.vocab_topk_lse(h, w, b, 9)
    with pytest.raises(ValueError, match="multiple of 8"):
        vocab_topk.vocab_topk_lse(torch.empty(9, 60, **meta),
                                  torch.empty(100, 60, **meta), b, 3)
    with pytest.raises(ValueError, match="shapes"):
        vocab_topk.vocab_topk_lse(h, w.t(), b, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        vocab_topk.vocab_topk_lse(h, w, torch.empty(100, device="meta"), 3)


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))


def _meta_int8(*shape, offset=0):
    """An int8 meta tensor whose data starts ``offset`` bytes into its
    storage (contiguous)."""
    n = int(np.prod(shape))
    return torch.empty(n + offset, device="meta", dtype=torch.int8)[offset:].view(*shape)


@pytest.mark.parametrize("case", [
    # TMA zero-fills the last 64-deep K stage: K needs only 16-byte rows
    "dequant K=48", "dequant K=16", "gated K=48", "gated K=16",
    # and H only 16-byte rows for the vocab head
    "vocab H=72", "vocab H=8",
    # the k range's ends, and R below one 128-row band
    "vocab k=1", "vocab k=8", "vocab R=1",
])
def test_rules_the_wgmma_kernels_take_reach_the_kernel(monkeypatch, tmp_path, case):
    """Shapes the TMA-fed kernels take pass every check and go to the build,
    which raises here (no nvcc) and counts no launch."""
    _no_nvcc(monkeypatch, tmp_path)
    meta = dict(device="meta", dtype=torch.bfloat16)
    kernel, arg = case.split()
    key, value = arg.split("=")
    value = int(value)
    if kernel == "dequant":
        call = lambda: feed_gemm.dequant_matmul(
            _meta_int8(10, value), torch.empty(10, **meta),
            torch.empty(value, 16, **meta))
    elif kernel == "gated":
        call = lambda: feed_gemm.dequant_matmul_gated_logits(
            _meta_int8(10, value), torch.empty(10, **meta),
            torch.empty(value, 16, **meta), torch.empty(16, **meta),
            torch.empty(2, 16, **meta), 5)
    else:
        dims = {"R": 9, "H": 64, "k": 3}
        dims[key] = value
        call = lambda: vocab_topk.vocab_topk_lse(
            torch.empty(dims["R"], dims["H"], **meta),
            torch.empty(100, dims["H"], **meta), torch.empty(100, **meta),
            dims["k"])
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        call()
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("case", [
    "dequant N", "dequant K", "dequant align", "vocab k=0", "vocab k>V",
    "vocab align", "gated N", "gated K", "gated align", "gated objs",
    "gated gate",
])
def test_wgmma_kernel_wrappers_refuse_before_any_build(monkeypatch, tmp_path, case):
    """What the redesigned kernels cannot take raises ValueError before the
    library is built: N not a multiple of 8, K not of 16, an x_q or h that
    does not start on a 16-byte boundary (TMA), k outside [1, min(8, V)];
    for the gated entry also M not a whole number of images and a gate
    whose shape is not [M / objs, N]."""
    _no_nvcc(monkeypatch, tmp_path)
    meta = dict(device="meta", dtype=torch.bfloat16)

    def gated(k, n, objs=5, offset=0, images=2):
        return lambda: feed_gemm.dequant_matmul_gated_logits(
            _meta_int8(10, k, offset=offset), torch.empty(10, **meta),
            torch.empty(k, n, **meta), torch.empty(n, **meta),
            torch.empty(images, n, **meta), objs)

    calls = {
        "gated N": (gated(64, 12), "N=12"),
        "gated K": (gated(24, 16), "K=24"),
        "gated align": (gated(64, 16, offset=1), "16-byte"),
        "gated objs": (gated(64, 16, objs=4, images=2), "whole number"),
        "gated gate": (gated(64, 16, images=3), "shapes"),
        "dequant N": (lambda: feed_gemm.dequant_matmul(
            _meta_int8(10, 64), torch.empty(10, **meta),
            torch.empty(64, 12, **meta)), "N=12"),
        "dequant K": (lambda: feed_gemm.dequant_matmul(
            _meta_int8(10, 24), torch.empty(10, **meta),
            torch.empty(24, 16, **meta)), "K=24"),
        "dequant align": (lambda: feed_gemm.dequant_matmul(
            _meta_int8(10, 64, offset=1), torch.empty(10, **meta),
            torch.empty(64, 16, **meta)), "16-byte"),
        "vocab k=0": (lambda: vocab_topk.vocab_topk_lse(
            torch.empty(9, 64, **meta), torch.empty(100, 64, **meta),
            torch.empty(100, **meta), 0), "k=0"),
        "vocab k>V": (lambda: vocab_topk.vocab_topk_lse(
            torch.empty(9, 64, **meta), torch.empty(5, 64, **meta),
            torch.empty(5, **meta), 6), r"k=6 must lie in \[1, 5\]"),
        "vocab align": (lambda: vocab_topk.vocab_topk_lse(
            torch.empty(9 * 64 + 1, **meta)[1:].view(9, 64),
            torch.empty(100, 64, **meta), torch.empty(100, **meta), 3),
            "16-byte"),
    }
    call, match = calls[case]
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("rows,vocab,sms", [
    (12288, 20000, 132), (3001, 20000, 132), (8, 20000, 132),
    (8, 1000, 132), (12288, 1000, 132), (1, 1, 132), (4096, 20000, 114),
    (512 * 3, 20000, 132),
])
def test_vocab_topk_plan_covers_the_vocabulary(rows, vocab, sms):
    """The plan's splits cover every vocabulary tile once, fit the partial
    buffers, and the grid is at most one block an SM with two units (one a
    consumer warpgroup) for each block."""
    tps, splits, grid = vocab_topk._plan(rows, vocab, sms)
    n_tiles = -(-vocab // vocab_topk._TILE_V)
    bands = -(-rows // vocab_topk._TILE_R)
    assert 1 <= splits <= vocab_topk._MAX_SPLITS
    assert (splits - 1) * tps < n_tiles <= splits * tps
    assert grid == min(sms, -(-bands * splits // 2))
    assert 1 <= grid <= sms


def test_vocab_topk_plan_at_the_decode_shape():
    """At the B=4096, k=3 decode (R = 12288, V = 20000) on a 132-SM H100:
    8 splits of 20 tiles, 768 units, 6 (three pairs) on each of 132 blocks;
    at R = 8 the splits fill the card instead (53 units of 3 tiles)."""
    assert vocab_topk._plan(12288, 20000, 132) == (20, 8, 132)
    assert vocab_topk._plan(8, 20000, 132) == (3, 53, 27)


# the batches the paths launch gru_v2 at (requests of 512, the CLI's
# decode), the timed ones, ragged ones and B=1; a 132-SM H100 and a 114-SM
# card; 16-block clusters schedulable, or only up to 8
@pytest.mark.parametrize("batch", [1, 512, 1003, 4096, 16384])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("max_cluster", [1, 8, 16])
@pytest.mark.parametrize("hidden", [1024, 96])
def test_gru_v2_plan_fills_one_wave(batch, sms, max_cluster, hidden):
    """The cluster size is one the kernel is built for, at most
    ``max_cluster``, divides H into 32-unit chunks (whole 64-unit K tiles
    when c > 1), keeps c blocks for each of the ceil(B / 64) row tiles
    within one wave (or is 1), and is the largest such size."""
    c = gru_v2._plan(batch, hidden, sms, max_cluster)
    tiles = -(-batch // 64)
    assert c in gru_v2._CLUSTERS and c <= max_cluster
    assert (hidden // c) % 32 == 0 and (c == 1 or (hidden // c) % 64 == 0)
    assert c == 1 or tiles * c <= sms
    bigger = 2 * c
    assert not (bigger <= min(max_cluster, 16) and hidden % (64 * bigger) == 0
                and tiles * bigger <= sms)


def test_gru_v2_plan_at_the_path_batches():
    """On a 132-SM H100 at H=1024: the requests' B=512 (8 row tiles) takes
    16-block clusters where they schedule, else 8; B=4096 pairs of blocks;
    B=8192 and 16384 single blocks; on a 114-SM card B=512 takes 8."""
    plan = gru_v2._plan
    assert plan(512, 1024, 132, 16) == 16
    assert plan(512, 1024, 132, 8) == 8
    assert plan(1000, 1024, 132, 16) == 8
    assert plan(2048, 1024, 132, 16) == 4
    assert plan(4096, 1024, 132, 16) == 2
    assert plan(8192, 1024, 132, 16) == 1
    assert plan(16384, 1024, 132, 16) == 1
    assert plan(512, 1024, 114, 16) == 8
    assert plan(512, 32, 132, 16) == 1
    assert plan(512, 192, 132, 16) == 1   # 96 units a block: not whole K tiles


@pytest.mark.parametrize("case", ["gru_v2 H=2048", "gru_v2 B=1",
                                  "gru_v2 B=1000"])
def test_shapes_the_gru_sequence_kernel_takes_reach_the_build(monkeypatch,
                                                              tmp_path, case):
    """An H whose state does not fit in shared memory, one row and a ragged
    B pass every check of gru_v2 and go to the build (the plan asks the
    card first), which raises here (no nvcc) and counts no launch."""
    _no_nvcc(monkeypatch, tmp_path)
    meta = dict(device="meta", dtype=torch.bfloat16)
    batch, hidden = {"gru_v2 H=2048": (512, 2048), "gru_v2 B=1": (1, 1024),
                     "gru_v2 B=1000": (1000, 1024)}[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        gru_v2.gru_last_state_v2(torch.empty(batch, 10, 3 * hidden, **meta),
                                 torch.empty(hidden, 3 * hidden, **meta),
                                 torch.empty(3 * hidden, **meta))
    assert _build.LAUNCHES == before


# the batches the paths launch the chain and the deferred reduction at (the
# requests' and the training path's B=512), the timed ones, a ragged one
# and B=1; the widths chip_smoke.py's phase 3 runs and the ends of what the
# wrappers take
PLAN_BATCHES = [1, 512, 1003, 4096, 8192]


@pytest.mark.parametrize("batch", PLAN_BATCHES)
@pytest.mark.parametrize("d", [2048, 1000, 8, 2056, 8192])
@pytest.mark.parametrize("sms", [132, 114])
def test_gcn_chain_plan_covers_every_tile_once(batch, d, sms):
    """Walking the bf16 chain kernel's blocks as it does (block i: column
    group i % groups, images i // groups + (grid // groups) q, the group's
    64-column tiles) covers every (image, tile) exactly once; the grid is
    at most one block an SM per group and a whole number of groups, the
    ring's depth a positive multiple of the four consumer pairs, and the
    shared memory within 227 KB."""
    groups, tpg, stages, grid = gcn_chain._plan(batch, d, sms)
    n_tiles = -(-d // gcn_chain._D_TILE)
    cover = np.zeros((batch, n_tiles), dtype=np.int64)
    per_group = grid // groups
    assert grid % groups == 0 and 1 <= per_group <= max(1, sms // groups)
    for block in range(grid):
        t0 = (block % groups) * tpg
        cover[block // groups::per_group, t0:min(n_tiles, t0 + tpg)] += 1
    assert (cover == 1).all()
    assert tpg <= gcn_chain._MAX_GROUP_TILES
    assert stages >= gcn_chain._PAIRS and stages % gcn_chain._PAIRS == 0
    assert gcn_chain._smem_bytes(stages, tpg) <= 232448


def test_gcn_chain_plan_at_the_path_batches():
    """On a 132-SM H100 at D=2048: one column group of 32 tiles whose bias
    stays resident, 8 ring stages, one block an SM at B=512 and 8192."""
    assert gcn_chain._plan(512, 2048, 132) == (1, 32, 8, 132)
    assert gcn_chain._plan(8192, 2048, 132) == (1, 32, 8, 132)
    assert gcn_chain._plan(3, 2048, 132) == (1, 32, 8, 3)
    assert gcn_chain._plan(8, 8192, 132) == (4, 32, 8, 32)


@pytest.mark.parametrize("batch", PLAN_BATCHES)
@pytest.mark.parametrize("objs, H", [(36, 1024), (64, 1024), (36, 1040),
                                     (5, 16), (36, 8192), (64, 4112)])
@pytest.mark.parametrize("T, itemsize", [(19, 2), (19, 4), (1, 2), (0, 2)])
def test_dvp_plan_covers_every_box_group_once(batch, objs, H, T, itemsize):
    """The deferred reduction's block items, as the kernel maps its 256
    consumer threads onto them (thread tid: group slice offset tid % gc,
    box set tid // gc of the item's slice, boxes nb set .. nb set + nb - 1),
    cover every (box, 16-lane group) of a row exactly once; the grid is two
    blocks an SM and at most one an item, a stage holds at least one step,
    and the shared memory fits."""
    nb, gc, tc, stages, grid = decode_att._dvp_plan(batch, objs, H, T,
                                                    itemsize, 132)
    G = H // decode_att.LANES
    sc, g_items, s_items = decode_att._dvp_items(objs, H, nb, gc)
    S = -(-objs // nb)
    cover = np.zeros((objs, G), dtype=np.int64)
    tid = np.arange(256)
    gl, sl = tid % gc, tid // gc
    for r in range(g_items * s_items):
        g = (r // s_items) * gc + gl
        box_set = (r % s_items) * sc + sl
        active = (sl < sc) & (g < G) & (box_set < S)
        for bx in range(nb):
            n = box_set * nb + bx
            ok = active & (n < objs)
            np.add.at(cover, (n[ok], g[ok]), 1)
    assert (cover == 1).all()
    assert 1 <= nb <= 4 and 1 <= gc <= 256 and tc >= 1 and stages >= 2
    assert grid == min(batch * g_items * s_items, 2 * 132)
    assert decode_att._dvp_smem_bytes(objs, gc, tc, stages, itemsize) <= 232448


def test_dvp_plan_at_the_path_shape():
    """At 36 boxes, H=1024, T=19 in bf16 on a 132-SM H100: 3 boxes a
    thread, so a row is 3 items of 64 groups x 4 box sets (every thread
    busy), 8 steps a stage (2 KB of qp each), 4 stages, two blocks an SM."""
    assert decode_att._dvp_plan(4096, 36, 1024, 19, 2, 132) == (3, 64, 8, 4, 264)
    assert decode_att._dvp_plan(512, 36, 1024, 19, 2, 132) == (3, 64, 8, 4, 264)
    assert decode_att._dvp_items(36, 1024, 3, 64) == (4, 1, 3)
