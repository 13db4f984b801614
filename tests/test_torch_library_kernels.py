"""The port's library kernels (vqa_tpu_torch/ops/kernels: fused_attention,
gru, gru_v3) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, held here against the
Pallas kernel in interpret mode at the shapes of tests/test_pallas.py and at
its tolerances (f32: rtol 1e-5 / atol 1e-6 for the attention weights, rtol
1e-4 / atol 1e-5 for the rest), against the port's own modules, and against
torch.nn.GRU. Meta tensors take the wrappers' kernel route without a card:
the shape and type checks run before any build. The CUDA kernels themselves
are held against the plain versions on the card by chip_smoke.py.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.ops.attention import MultiplyAttention as JaxMultiplyAttention
from vqa_tpu.ops.pallas.fused_attention import (
    fused_multiply_attention_pool as jax_fused_attention)
from vqa_tpu.ops.pallas.gru import gru_last_state as jax_gru_last_state
from vqa_tpu.ops.pallas.gru_v3 import gru_last_state_v3 as jax_gru_v3
from vqa_tpu_torch.ops import kernels
from vqa_tpu_torch.ops.attention import MultiplyAttention
from vqa_tpu_torch.ops.kernels import (
    _build, fused_attention, gru, gru_v2, gru_v3)
from vqa_tpu_torch.ops.rnn import rnn_scan
from vqa_tpu_torch.tools.convert import flax_to_state_dict

BF16 = ml_dtypes.bfloat16
ATT_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


def attention_inputs(rng, B, N, Dv, H, Hq):
    """tests/test_pallas.py's fused-attention operands."""
    return (rng.standard_normal((B, N, Dv)).astype(np.float32),
            rng.standard_normal((B, Hq)).astype(np.float32),
            (rng.standard_normal((Dv, H)) * 0.05).astype(np.float32),
            rng.standard_normal(H).astype(np.float32) * 0.1,
            (rng.standard_normal((Hq, H)) * 0.05).astype(np.float32),
            rng.standard_normal(H).astype(np.float32) * 0.1,
            (rng.standard_normal((H, 1)) * 0.1).astype(np.float32),
            rng.standard_normal(1).astype(np.float32) * 0.1)


@pytest.mark.parametrize("shape", [(32, 12, 64, 48, 40), (16, 9, 32, 24, 24),
                                   (8, 100, 64, 48, 40)])
def test_attention_plain_matches_pallas(rng, shape):
    """multiply_attention_pool_reference (and the wrapper on CPU tensors)
    against JAX's kernel in interpret mode, at both JAX test shapes and at
    100 boxes (bottom-up features with adaptive boxes: 10-100 an image)."""
    args = attention_inputs(rng, *shape)
    want_pool, want_att = jax_fused_attention(*map(jnp.asarray, args),
                                              tile_b=8, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    for fn in (fused_attention.multiply_attention_pool_reference,
               fused_attention.fused_multiply_attention_pool):
        pooled, att = fn(*targs)
        assert pooled.dtype == att.dtype == torch.float32
        assert pooled.shape == (shape[0], shape[2]) and att.shape == shape[:2]
        np.testing.assert_allclose(att.numpy(), np.asarray(want_att), **ATT_TOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pool), **TOL)


def test_attention_plain_matches_the_ports_module(rng):
    """The plain version on weights folded from the port's MultiplyAttention
    (weights converted from the flax module) equals that module's softmax
    in eval mode and the pooling over it."""
    B, N, Dv, H = 16, 9, 32, 24
    v = rng.standard_normal((B, N, Dv)).astype(np.float32)
    q = rng.standard_normal((B, H)).astype(np.float32)
    params = JaxMultiplyAttention(hidden_dim=H).init(
        jax.random.key(0), jnp.asarray(v), jnp.asarray(q))["params"]
    module = MultiplyAttention(Dv, H, H).eval()
    module.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    tv, tq = torch.from_numpy(v), torch.from_numpy(q)
    fc_v, fc_q = module.W_v.main[0], module.W_q.main[0]
    fold = (fc_v.weight(torch.float32).t(), fc_v.bias,
            fc_q.weight(torch.float32).t(), fc_q.bias,
            module.linear.weight(torch.float32).t(), module.linear.bias)
    with torch.no_grad():
        want_att = module(tv, tq)[..., 0]
        pooled, att = fused_attention.multiply_attention_pool_reference(
            tv, tq, *fold)
    np.testing.assert_allclose(att.numpy(), want_att.numpy(), **ATT_TOL)
    np.testing.assert_allclose(pooled.numpy(),
                               torch.einsum("bn,bnd->bd", want_att, tv).numpy(),
                               **TOL)


def test_attention_plain_upcasts_bf16_operands(rng):
    """bf16 operands: every product and sum is f32 (the TPU kernel's
    rounding points), so the plain version equals itself on the same values
    in f32."""
    args = attention_inputs(rng, 8, 36, 64, 32, 40)
    bf = [torch.from_numpy(a.astype(BF16).astype(np.float32)) for a in args]
    got = fused_attention.multiply_attention_pool_reference(
        *[t.to(torch.bfloat16) for t in bf])
    want = fused_attention.multiply_attention_pool_reference(*bf)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def gru_inputs(rng, B, T, H):
    return ((rng.standard_normal((B, T, 3 * H))).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) * 0.1).astype(np.float32),
            rng.standard_normal(3 * H).astype(np.float32) * 0.1)


@pytest.mark.parametrize("batch", [16, 24])
def test_gru_plain_matches_pallas(rng, batch):
    xi, wh, bh = gru_inputs(rng, batch, 10, 32)
    want = jax_gru_last_state(*map(jnp.asarray, (xi, wh, bh)), tile_b=8,
                              interpret=True)
    for fn in (gru.gru_last_state_reference, gru.gru_last_state):
        got = fn(*map(torch.from_numpy, (xi, wh, bh)))
        assert got.dtype == torch.float32 and got.shape == (batch, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gru_plain_matches_torch_gru(rng):
    """xi from torch.nn.GRU's input weights; the plain version's last state
    equals the GRU's last output (tests/test_pallas.py's case)."""
    B, T, in_dim, H = 8, 6, 12, 16
    torch.manual_seed(0)
    ref = torch.nn.GRU(input_size=in_dim, hidden_size=H, batch_first=True)
    x = torch.from_numpy(rng.standard_normal((B, T, in_dim)).astype(np.float32))
    with torch.no_grad():
        want = ref(x)[0][:, -1]
        xi = x @ ref.weight_ih_l0.t() + ref.bias_ih_l0
        got = gru.gru_last_state_reference(xi, ref.weight_hh_l0.t(),
                                           ref.bias_hh_l0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_gru_v1_equals_v2_on_bf16_operands(rng):
    """v1 keeps v2's rounding points: on the same bf16 operands the plain
    versions agree exactly (the kernels agree within bf16 rounding on the
    card, chip_smoke.py)."""
    xi, wh, bh = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in gru_inputs(rng, 16, 10, 32))
    np.testing.assert_array_equal(
        gru.gru_last_state(xi, wh, bh).numpy(),
        gru_v2.gru_last_state_v2(xi, wh, bh).numpy())


def v3_inputs(rng, B, T, E, H):
    return (rng.standard_normal((B, T, E)).astype(np.float32),
            (rng.standard_normal((E, 3 * H)) * 0.1).astype(np.float32),
            rng.standard_normal(3 * H).astype(np.float32) * 0.1,
            (rng.standard_normal((H, 3 * H)) * 0.1).astype(np.float32),
            rng.standard_normal(3 * H).astype(np.float32) * 0.1)


@pytest.mark.parametrize("e_dim", [12, 13])
def test_gru_v3_plain_matches_pallas_and_the_scan(rng, e_dim):
    """gru_last_state_v3_reference against JAX's v3 kernel in interpret mode
    (which pads E to 128 with zeros) and against the port's GRU scan."""
    B, T, H = 16, 6, 32
    args = v3_inputs(rng, B, T, e_dim, H)
    want = jax_gru_v3(*map(jnp.asarray, args), tile_b=8, interpret=True)
    emb, wi, bi, wh, bh = map(torch.from_numpy, args)
    scan = rnn_scan(emb, wi.t(), bi, wh.t(), bh)[:, -1]
    for fn in (gru_v3.gru_last_state_v3_reference, gru_v3.gru_last_state_v3):
        got = fn(emb, wi, bi, wh, bh)
        assert got.dtype == torch.float32 and got.shape == (B, H)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), scan.numpy(), **TOL)


def test_gru_v3_keeps_its_input_gates_f32(rng):
    """v3's input gates are the f32 product plus bi, not rounded to bf16
    as the v2 route's precomputed xi is: v3 equals the recurrence on the f32
    gates exactly, and differs from v2 on the bf16-rounded gates."""
    emb, wi, bi, wh, bh = (torch.from_numpy(a).to(torch.bfloat16)
                           for a in v3_inputs(rng, 16, 10, 300 // 10, 32))
    xi = torch.matmul(emb.float(), wi.float()) + bi.float()
    got = gru_v3.gru_last_state_v3(emb, wi, bi, wh, bh)
    np.testing.assert_array_equal(
        got.numpy(), gru_v2.gru_last_state_v2_reference(xi, wh, bh).numpy())
    v2_route = gru_v2.gru_last_state_v2(xi.to(torch.bfloat16), wh, bh)
    assert not torch.equal(got, v2_route)
    np.testing.assert_allclose(got.numpy(), v2_route.numpy(), atol=2e-2)


def test_library_exports_build_nothing():
    """The package exports the JAX library's four names; importing it (and
    running every plain version above) builds and loads no kernel."""
    assert kernels.__all__ == [
        "fused_multiply_attention_pool", "multiply_attention_pool_reference",
        "gru_last_state", "gru_last_state_reference"]
    assert kernels.gru_last_state is gru.gru_last_state
    assert kernels.fused_multiply_attention_pool \
        is fused_attention.fused_multiply_attention_pool
    assert _build._lib is None


META = dict(device="meta", dtype=torch.bfloat16)


def meta_attention(B=4, N=36, Dv=64, H=32, Hq=40, vec=torch.float32):
    return (torch.empty(B, N, Dv, **META), torch.empty(B, Hq, **META),
            torch.empty(Dv, H, **META), torch.empty(H, device="meta", dtype=vec),
            torch.empty(Hq, H, **META), torch.empty(H, device="meta", dtype=vec),
            torch.empty(H, 1, device="meta", dtype=vec),
            torch.empty(1, device="meta", dtype=vec))


def test_library_wrappers_reject_what_the_kernels_do_not_take():
    """Off the CPU the wrappers check shapes and types before any build."""
    with pytest.raises(ValueError, match="N=257"):
        fused_attention.fused_multiply_attention_pool(*meta_attention(N=257))
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_attention.fused_multiply_attention_pool(*meta_attention(H=20))
    with pytest.raises(ValueError, match="shapes"):
        args = list(meta_attention())
        args[6] = torch.empty(1, 32, **META)
        fused_attention.fused_multiply_attention_pool(*args)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention.fused_multiply_attention_pool(
            *meta_attention(vec=torch.float16))
    with pytest.raises(TypeError, match="bfloat16"):
        args = list(meta_attention())
        args[0] = torch.empty(4, 36, 64, device="meta")
        fused_attention.fused_multiply_attention_pool(*args)
    with pytest.raises(ValueError, match="multiple of 32"):
        gru.gru_last_state(torch.empty(8, 3, 60, **META),
                           torch.empty(20, 60, **META), torch.empty(60, **META))
    with pytest.raises(TypeError, match="bfloat16"):
        gru.gru_last_state(torch.empty(8, 3, 96, device="meta"),
                           torch.empty(32, 96, **META), torch.empty(96, **META))
    with pytest.raises(ValueError, match="shapes"):
        gru_v3.gru_last_state_v3(torch.empty(8, 3, 300, **META),
                                 torch.empty(301, 96, **META),
                                 torch.empty(96, **META),
                                 torch.empty(32, 96, **META),
                                 torch.empty(96, **META))


def test_library_wrappers_send_other_devices_to_the_kernel(monkeypatch,
                                                           tmp_path):
    """Only a CPU tensor takes the plain version: valid operands on any other
    device go to the kernel, which here cannot be built, so each wrapper
    raises and counts no launch. A GRU whose state is too wide for shared
    memory passes the wrapper's checks too: the kernel keeps that state in
    device memory (chip_smoke.py holds it against the plain version on the
    card)."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    calls = [
        lambda: fused_attention.fused_multiply_attention_pool(
            *meta_attention(vec=torch.bfloat16)),
        lambda: gru.gru_last_state(torch.empty(8, 3, 96, **META),
                                   torch.empty(32, 96, **META),
                                   torch.empty(96, **META)),
        lambda: gru_v3.gru_last_state_v3(
            torch.empty(8, 3, 300, **META), torch.empty(300, 96, **META),
            torch.empty(96, **META), torch.empty(32, 96, **META),
            torch.empty(96, **META)),
        lambda: gru.gru_last_state(torch.empty(8, 3, 3 * 2048, **META),
                                   torch.empty(2048, 3 * 2048, **META),
                                   torch.empty(3 * 2048, **META)),
    ]
    before = dict(_build.LAUNCHES)
    for call in calls:
        with pytest.raises(_build.KernelBuildError):
            call()
    assert _build.LAUNCHES == before


# what gru_query reports on a 132-SM H100 at 227 KB a block: the state stays
# resident up to H=1024; clusters of each size the card holds at once
H100_CLUSTERS = {1: 132, 2: 66, 4: 32, 8: 16, 16: 7}


def record_launches(monkeypatch):
    """Replace ``_build.launch`` with a recorder of (kernel, entry, args),
    and the sequence kernel's query of the card with an H100's answer."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, device, *args:
                        calls.append((kernel, entry, args)))
    monkeypatch.setattr(gru_v2, "_device_caps", lambda device, hidden, v3: (
        hidden <= 1024, 132,
        {c: n if gru_v2.cluster_fits(hidden, c) else 0
         for c, n in H100_CLUSTERS.items()}))
    return calls


def expected_cluster(batch, hidden):
    """The plan on that H100: 16-block clusters do not all fit at once for
    8 row tiles (7 of them), so B=512 takes 8."""
    tiles = -(-batch // 64)
    max_cluster = max(c for c, n in H100_CLUSTERS.items()
                      if c == 1 or (n >= tiles and gru_v2.cluster_fits(hidden, c)))
    return gru_v2._plan(batch, hidden, 132, max_cluster)


# (B, T, H): the JAX test shapes, a ragged B, full width, and an H whose
# state does not fit in shared memory (it lives in a [2, B, H] bf16 buffer
# that the wrapper allocates)
@pytest.mark.parametrize("batch, t_len, hidden", [(16, 10, 32), (16, 6, 32),
                                                  (1003, 10, 1024),
                                                  (16384, 10, 1024),
                                                  (64, 2, 2048)])
def test_gru_v1_wrapper_hands_the_kernel_its_operands(monkeypatch, batch,
                                                      t_len, hidden):
    """v1 passes xi as it is, the recurrent weight gate-major ([3H, H],
    K-major: the wgmma B operand the TMA loads), bh, the device-memory state
    where the state is not resident (else None), B, T, H and the plan's
    cluster size."""
    calls = record_launches(monkeypatch)
    xi = torch.empty(batch, t_len, 3 * hidden, **META)
    out = gru.gru_last_state(xi, torch.empty(hidden, 3 * hidden, **META),
                             torch.empty(3 * hidden, **META))
    assert out.shape == (batch, hidden) and out.dtype == torch.float32
    [(kernel, entry, args)] = calls
    assert (kernel, entry) == ("gru_last_state", "gru_last_state_forward")
    assert args[0] is xi
    assert args[1].shape == (3 * hidden, hidden) and args[1].is_contiguous()
    assert args[2].shape == (3 * hidden,) and args[3] is out
    if hidden <= 1024:
        assert args[4] is None
    else:
        assert args[4].shape == (2, batch, hidden)
        assert args[4].dtype == torch.bfloat16
    assert args[5:] == (batch, t_len, hidden,
                        expected_cluster(batch, hidden))


# (B, T, E, H): the JAX test shapes (E=12 pads to 16), a ragged B at the
# serving model's E=300 (pads to 304), an E already a multiple of 8
@pytest.mark.parametrize("batch, t_len, e_dim, hidden", [
    (16, 10, 12, 32), (16, 6, 12, 32), (1003, 10, 300, 1024),
    (16384, 10, 300, 1024), (40, 3, 64, 96)])
def test_gru_v3_wrapper_hands_the_kernel_its_operands(monkeypatch, batch,
                                                      t_len, e_dim, hidden):
    """v3 pads emb with zeros along E to E8, a multiple of 8 (TMA's 16-byte
    row pitch), only where E is not one, and hands the kernel the input
    weight gate-major and zero-padded alike ([3H, E8]), then (no
    device-memory state at these H) B, T, H, E, E8 and the cluster size."""
    calls = record_launches(monkeypatch)
    gates, e8 = 3 * hidden, -(-e_dim // 8) * 8
    emb = torch.empty(batch, t_len, e_dim, **META)
    out = gru_v3.gru_last_state_v3(emb, torch.empty(e_dim, gates, **META),
                                   torch.empty(gates, **META),
                                   torch.empty(hidden, gates, **META),
                                   torch.empty(gates, **META))
    assert out.shape == (batch, hidden)
    [(kernel, entry, args)] = calls
    assert (kernel, entry) == ("gru_last_state_v3", "gru_last_state_v3_forward")
    emb8, wi_t = args[0], args[1]
    assert emb8.shape == (batch, t_len, e8) and emb8.is_contiguous()
    assert (emb8 is emb) == (e8 == e_dim)
    assert wi_t.shape == (gates, e8) and wi_t.is_contiguous()
    assert args[3].shape == (gates, hidden) and args[5] is out
    assert args[6] is None
    assert args[7:] == (batch, t_len, hidden, e_dim, e8,
                        expected_cluster(batch, hidden))


@pytest.mark.parametrize("hidden", [48, 100])
def test_gru_wrappers_refuse_before_any_launch(monkeypatch, hidden):
    """An H the kernel's 32-unit chunks do not divide is refused by both
    wrappers: no launch is made or counted."""
    calls = record_launches(monkeypatch)
    before = dict(_build.LAUNCHES)
    gates = 3 * hidden
    with pytest.raises(ValueError, match="multiple of 32"):
        gru.gru_last_state(torch.empty(8, 3, gates, **META),
                           torch.empty(hidden, gates, **META),
                           torch.empty(gates, **META))
    with pytest.raises(ValueError, match="multiple of 32"):
        gru_v3.gru_last_state_v3(torch.empty(8, 3, 12, **META),
                                 torch.empty(12, gates, **META),
                                 torch.empty(gates, **META),
                                 torch.empty(hidden, gates, **META),
                                 torch.empty(gates, **META))
    assert calls == [] and _build.LAUNCHES == before


# what fused_attention_query reports on an NVIDIA H100 80GB HBM3 (chip_smoke.py
# phase 12 logs it): 33,312 bytes of shared memory beside the ring, 49,168 a
# 64-deep stage of a 256-row v tile and a 128-row Wv tile with its two
# barriers, 227 KB a block, 132 SMs
H100 = fused_attention.Card(fixed=33312, per_stage=49168, smem_limit=232448, sms=132)


# the attention kernel's plan: (B, N, H) -> (images a tile, cluster, passes,
# stages, grid) on the H100. Serving shape: 7 images of 36 boxes a 256-row
# tile, clusters of 4 blocks taking two 128-column tiles of H=1024 each, 4
# stages, 33 clusters; the JAX test shapes fit one column tile, so one block
# a cluster; H=1040 is 9 column tiles: no cluster of 2 or 4 divides them
@pytest.mark.parametrize("batch, objs, hidden, want", [
    (16384, 36, 1024, (7, 4, 2, 4, 132)),
    (1003, 36, 1024, (7, 4, 2, 4, 132)),
    (32, 12, 48, (21, 1, 1, 4, 2)),
    (16, 9, 24, (28, 1, 1, 4, 1)),
    (8, 100, 48, (2, 1, 1, 4, 4)),
    (1003, 36, 1040, (7, 1, 9, 4, 132)),
])
def test_attention_plan_pinned(batch, objs, hidden, want):
    assert fused_attention._plan(batch, objs, hidden, H100) == want


@pytest.mark.parametrize("batch, objs, hidden, sms", [
    (16384, 36, 1024, 132), (1003, 36, 1024, 132), (1, 36, 1024, 132),
    (32, 12, 48, 132), (16, 9, 24, 132), (8, 100, 48, 132),
    (1003, 36, 1040, 132), (5, 128, 2048, 132), (300, 1, 8, 132),
    (77, 7, 520, 114), (4096, 36, 384, 78), (3, 36, 4096, 16),
    (5, 256, 1024, 132), (9, 255, 64, 132), (40, 129, 136, 132),
    (1000, 85, 256, 132), (64, 64, 2048, 132), (1003, 100, 1024, 132),
    (16384, 10, 1024, 132), (2, 36, 8, 132), (7, 2, 640, 132),
    (513, 36, 896, 132), (250, 50, 1152, 132), (16384, 36, 4096, 132),
])
def test_attention_plan_properties(batch, objs, hidden, sms):
    """Every image lies in exactly one M tile and every tile in exactly one
    cluster's walk; a tile's images fit its 256 rows; the cluster's blocks
    cover H with no column tile wholly past it; the ring is as deep as the
    card's shared memory allows; the grid is whole clusters, at most one
    block an SM."""
    card = H100._replace(sms=sms)
    images, cluster, passes, stages, grid = fused_attention._plan(
        batch, objs, hidden, card)
    assert 1 <= images and images * objs <= 256
    tiles = -(-batch // images)
    clusters = grid // cluster
    assert grid % cluster == 0 and 1 <= clusters <= tiles and grid <= sms
    walked = sorted(t for c in range(clusters) for t in range(c, tiles, clusters))
    assert walked == list(range(tiles))
    covered = sorted(i for t in walked
                     for i in range(t * images, min(batch, (t + 1) * images)))
    assert covered == list(range(batch))
    assert cluster in (1, 2, 4)
    col_tiles = cluster * passes
    assert (col_tiles - 1) * 128 < hidden <= col_tiles * 128
    assert stages >= 2
    assert card.fixed + stages * card.per_stage <= card.smem_limit \
        < card.fixed + (stages + 1) * card.per_stage


@pytest.mark.parametrize("dims", [dict(Dv=60), dict(H=20), dict(Hq=36),
                                  dict(N=257), dict(N=1000)])
def test_attention_wrapper_refuses_before_any_build(monkeypatch, tmp_path, dims):
    """N above 256 and Dv, H or Hq not multiples of 8 raise ValueError before
    the library is built or a launch counted."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="boxes|multiples of 8"):
        fused_attention.fused_multiply_attention_pool(*meta_attention(**dims))
    assert _build._lib is None and _build.LAUNCHES == before


# (B, N, Dv, H, Hq, vec dtype): the JAX test shapes, 100 and 256 boxes, a
# ragged B at the serving width, an H of 9 column tiles, the narrowest
# widths, bf16 vectors, and B=0
@pytest.mark.parametrize("batch, objs, v_dim, hidden, q_dim, vec", [
    (32, 12, 64, 48, 40, torch.float32), (16, 9, 32, 24, 24, torch.float32),
    (8, 100, 64, 48, 40, torch.float32), (3, 256, 2048, 1024, 1024, torch.float32),
    (1003, 36, 2048, 1024, 1024, torch.bfloat16), (200, 36, 2048, 1040, 1024, torch.float32),
    (5, 1, 8, 8, 8, torch.bfloat16), (0, 36, 64, 48, 40, torch.float32),
])
def test_attention_shapes_it_takes_reach_the_kernel(monkeypatch, batch, objs,
                                                    v_dim, hidden, q_dim, vec):
    """Shapes the kernel takes pass every check and reach one launch (one
    count for its two kernels) with the weights K-major ([H, Dv], [H, Hq]),
    a scratch of (B + 2) Hp f32 for qp and the f32 bv and wl (Hp: H in whole
    128-column tiles), the outputs, the vectors' bf16 bits and the plan
    made from what the kernel reports of itself and the card."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda kernel, entry, device, *args:
                        calls.append((kernel, entry, args)))
    monkeypatch.setattr(fused_attention, "_card", lambda device: H100)
    args = meta_attention(batch, objs, v_dim, hidden, q_dim, vec)
    pooled, att = fused_attention.fused_multiply_attention_pool(*args)
    assert pooled.shape == (batch, v_dim) and att.shape == (batch, objs)
    assert pooled.dtype == att.dtype == torch.float32
    [(kernel, entry, got)] = calls
    assert (kernel, entry) == ("fused_multiply_attention_pool",
                               "fused_attention_forward")
    v, q, wv_t, wq_t, bv, bq, wl, bl, qp, out_p, out_a = got[:11]
    assert v is args[0] and q is args[1]
    assert wv_t.shape == (hidden, v_dim) and wv_t.is_contiguous()
    assert wq_t.shape == (hidden, q_dim) and wq_t.is_contiguous()
    assert (bv, bq, wl, bl) == (args[3], args[5], args[6], args[7])
    h_pad = -(-hidden // 128) * 128
    assert qp.shape == ((batch + 2) * h_pad,) and qp.dtype == torch.float32
    assert out_p is pooled and out_a is att
    bits = 15 if vec == torch.bfloat16 else 0
    assert got[11:] == (batch, objs, v_dim, hidden, q_dim, bits,
                        *fused_attention._plan(batch, objs, hidden, H100))


@pytest.mark.parametrize("batch, objs, hidden", [(8, 100, 48), (3, 256, 1024),
                                                 (200, 36, 1040)])
def test_attention_shapes_it_takes_reach_the_build(monkeypatch, tmp_path,
                                                   batch, objs, hidden):
    """Without nvcc those shapes reach the build, which raises; no launch is
    counted."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        fused_attention.fused_multiply_attention_pool(
            *meta_attention(batch, objs, 64, hidden, 40))
    assert _build.LAUNCHES == before
