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


@pytest.mark.parametrize("shape", [(32, 12, 64, 48, 40), (16, 9, 32, 24, 24)])
def test_attention_plain_matches_pallas(rng, shape):
    """multiply_attention_pool_reference (and the wrapper on CPU tensors)
    against JAX's kernel in interpret mode, at both JAX test shapes."""
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
    with pytest.raises(ValueError, match="N=65"):
        fused_attention.fused_multiply_attention_pool(*meta_attention(N=65))
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
    raises and counts no launch. A GRU too wide for shared memory passes the
    wrapper's checks too: its launch refuses it (chip_smoke.py checks that
    on the card)."""
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


def record_launches(monkeypatch):
    """Replace ``_build.launch`` with a recorder of (kernel, entry, args)."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, device, *args:
                        calls.append((kernel, entry, args)))
    return calls


# (B, T, H): the JAX test shapes, a ragged B, full width, and an H whose
# state does not fit in shared memory (the wrapper passes it: the launch
# refuses it on the card, before the kernel runs)
@pytest.mark.parametrize("batch, t_len, hidden", [(16, 10, 32), (16, 6, 32),
                                                  (1003, 10, 1024),
                                                  (16384, 10, 1024),
                                                  (64, 2, 2048)])
def test_gru_v1_wrapper_hands_the_kernel_its_operands(monkeypatch, batch,
                                                      t_len, hidden):
    """v1 passes xi as it is, the recurrent weight gate-major ([3H, H],
    K-major: the wgmma B operand the TMA loads), bh, and B, T, H."""
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
    assert args[4:] == (batch, t_len, hidden)


# (B, T, E, H): the JAX test shapes (E=12 pads to 16), a ragged B at the
# serving model's E=300 (pads to 304), an E already a multiple of 8
@pytest.mark.parametrize("batch, t_len, e_dim, hidden", [
    (16, 10, 12, 32), (16, 6, 12, 32), (1003, 10, 300, 1024),
    (16384, 10, 300, 1024), (40, 3, 64, 96)])
def test_gru_v3_wrapper_hands_the_kernel_its_operands(monkeypatch, batch,
                                                      t_len, e_dim, hidden):
    """v3 pads emb with zeros along E to E8, a multiple of 8 (TMA's 16-byte
    row pitch), only where E is not one, and hands the kernel the input
    weight gate-major and zero-padded alike ([3H, E8]), then B, T, H, E,
    E8."""
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
    assert args[6:] == (batch, t_len, hidden, e_dim, e8)


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
