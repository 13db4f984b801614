"""The port's int8 GEMM path (vqa_tpu_torch/ops/quant.py and
ops/kernels/int8_matmul.py) against vqa_tpu's.

The quantizers and the int8 kernel's plain version must equal JAX's bit for
bit: the int32 sums are exact, and every other step is one IEEE operation
in the same order on both sides. One exception: with an f32 output and a
bias, XLA's CPU compiler contracts the scaling multiply and the bias add
into one fused multiply-add (one rounding where the port rounds twice), so
those cases agree to one f32 rounding of the scaled sum. In bf16, the
model's dtype on the card, the cast between the two steps leaves nothing to
contract. JAX's Pallas kernels run in interpret mode, as tests/test_pallas.py
runs them. The CUDA kernel is held against the plain version, bit for bit,
by chip_smoke.py.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vqa_tpu.ops.pallas.int8_matmul import (
    int8_matmul_dequant as jax_int8_matmul,
    int8_matmul_dequant_3d as jax_int8_matmul_3d,
)
from vqa_tpu.ops.quant import (
    int8_dot as jax_int8_dot,
    quantize_rows as jax_quantize_rows,
    quantize_weight_per_col as jax_quantize_weight,
)
from vqa_tpu_torch.ops.kernels import _build, int8_matmul
from vqa_tpu_torch.ops.quant import (
    int8_dot, quantize_rows, quantize_weight_per_col)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def same(got: torch.Tensor, want, fma: bool = False) -> None:
    """Bit for bit (compared as f32, which holds every bf16 exactly); with
    ``fma`` (an f32 output with a bias) within one f32 rounding of the
    largest value, 2**-23 of it, the most that XLA's contraction moves."""
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    if fma:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2.0 ** -23 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array in ``dtype``."""
    if dtype == "bf16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    t, j = DTYPES[dtype]
    return torch.from_numpy(np.asarray(a, np.float32)).to(t), jnp.asarray(a, j)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_matches_jax(rng, dtype):
    """Rows whose abs-max is 127 have scale 1, so their x.5 values sit on a
    rounding midpoint: both round half to even. An all-zero row takes the
    1e-8 floor."""
    x = rng.standard_normal((5, 7, 64)).astype(np.float32) * 3
    x[0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[0, 0, 6:] = 1.0
    x[1, 2] = 0.0
    xt, xj = pair(x, dtype)
    (q, s), (wq, ws) = quantize_rows(xt), jax_quantize_rows(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    same(q, wq)
    same(s, ws)
    assert q[0, 0, :6].tolist() == [127, 2, -4, 0, 0, 126]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_weight_per_col_matches_jax(rng, dtype):
    """Per output column, divided by the scale; a column whose abs-max is
    127 puts its x.5 values on midpoints; an all-zero column takes the f32
    tiny floor. The port's w_q is the transpose of a contiguous [out, in]
    tensor (the kernel's layout)."""
    k = (rng.standard_normal((64, 24)) * 0.05).astype(np.float32)
    k[:5, 3] = [127.0, 4.5, -5.5, 0.5, 1.5]
    k[:, 7] = 0.0
    kt, kj = pair(k, dtype)
    (q, s), (wq, ws) = quantize_weight_per_col(kt), jax_quantize_weight(kj)
    same(q, wq)
    same(s, ws)
    assert q.t().is_contiguous()
    assert q[:5, 3].tolist() == [127, 4, -6, 0, 2]


def _operands(rng, shape, n, xs_dtype="f32"):
    k = shape[-1]
    x_q = rng.integers(-127, 128, shape).astype(np.int8)
    x_scale = rng.random(shape[:-1]).astype(np.float32) * 0.1 + 1e-3
    kernel = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
    xs_t, xs_j = pair(x_scale, xs_dtype)
    return x_q, (xs_t, xs_j), kernel, bias


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["plain", "bias", "bias+relu", "relu"])
def test_int8_matmul_plain_matches_pallas(rng, out_dtype, epilogue):
    """2-D entry on a ragged M (700 rows, off JAX's 256-row tile), with
    each epilogue: bit for bit."""
    x_q, (xs_t, xs_j), kernel, bias = _operands(rng, (700, 256), 128)
    w_q, w_scale = jax_quantize_weight(jnp.asarray(kernel))
    t_dt, j_dt = DTYPES[out_dtype]
    with_bias, relu = "bias" in epilogue, "relu" in epilogue
    b_t, b_j = pair(bias, out_dtype)
    want = jax_int8_matmul(jnp.asarray(x_q), xs_j, w_q, w_scale,
                           out_dtype=j_dt, bias=b_j if with_bias else None,
                           relu=relu, tile_m=256, interpret=True)
    got = int8_matmul.int8_matmul_dequant(
        torch.from_numpy(x_q), xs_t, torch.from_numpy(np.array(w_q)),
        torch.from_numpy(np.array(w_scale)),
        bias=b_t if with_bias else None, relu=relu, out_dtype=t_dt)
    assert got.dtype == t_dt
    same(got, want, fma=with_bias and out_dtype == "f32")


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("out_dtype,epilogue", [
    ("bf16", "plain"), ("bf16", "bias+relu"), ("f32", "bias+relu")])
def test_int8_matmul_3d_plain_matches_pallas(rng, flatten, out_dtype,
                                             epilogue):
    """3-D entry, B off JAX's 8-image tile, both of its in-kernel
    contraction forms, bf16 scales (the int8 feed's): bit for bit."""
    x_q, (xs_t, xs_j), kernel, bias = _operands(rng, (37, 12, 256), 128,
                                                xs_dtype="bf16")
    w_q, w_scale = jax_quantize_weight(jnp.asarray(kernel))
    t_dt, j_dt = DTYPES[out_dtype]
    with_bias, relu = "bias" in epilogue, "relu" in epilogue
    b_t, b_j = pair(bias, out_dtype)
    want = jax_int8_matmul_3d(jnp.asarray(x_q), xs_j, w_q, w_scale,
                              bias=b_j if with_bias else None, relu=relu,
                              out_dtype=j_dt, tile_b=8, flatten=flatten,
                              interpret=True)
    got = int8_matmul.int8_matmul_dequant_3d(
        torch.from_numpy(x_q), xs_t, torch.from_numpy(np.array(w_q)),
        torch.from_numpy(np.array(w_scale)),
        bias=b_t if with_bias else None, relu=relu, out_dtype=t_dt)
    assert got.shape == (37, 12, 128)
    same(got, want, fma=with_bias and out_dtype == "f32")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape,xs_dtype,out_dtype", [
    ((4, 260, 256), "f32", "bf16"), ((16, 36, 128), "bf16", "bf16"),
    ((300, 128), "f32", "f32")])
def test_int8_dot_matches_jax(rng, use_pallas, shape, xs_dtype, out_dtype):
    """The port's int8_dot against JAX's on both of JAX's routes (its XLA
    dot, and with ``use_pallas`` its Pallas kernels where their gates admit
    the shape, in interpret mode), with the bias and ReLU epilogue: bit for
    bit. The port sends 3-D ``use_pallas`` calls to the 3-D entry and the
    rest to the 2-D one."""
    x_q, (xs_t, xs_j), kernel, bias = _operands(rng, shape, 128, xs_dtype)
    t_dt, j_dt = DTYPES[out_dtype]
    want = jax_int8_dot(jnp.asarray(x_q), xs_j, jnp.asarray(kernel),
                        out_dtype=j_dt, use_pallas=use_pallas,
                        bias=jnp.asarray(bias), relu=True)
    got = int8_dot(torch.from_numpy(x_q), xs_t, torch.from_numpy(kernel),
                   out_dtype=t_dt, use_pallas=use_pallas,
                   bias=torch.from_numpy(bias), relu=True)
    assert got.dtype == t_dt
    same(got, want, fma=out_dtype == "f32")


def test_int8_dot_routes_to_the_entries(rng, monkeypatch):
    """``use_pallas`` with a 3-D input takes the 3-D entry; everything else
    the 2-D entry on the flattened rows."""
    calls = []
    for name in ("int8_matmul_dequant", "int8_matmul_dequant_3d"):
        fn = getattr(int8_matmul, name)
        monkeypatch.setattr(int8_matmul, name,
                            lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 3, 32)).astype(np.int8))
    s = torch.ones(2, 3)
    k = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    for pallas in (True, False):
        assert int8_dot(x, s, k, use_pallas=pallas).shape == (2, 3, 8)
    assert int8_dot(x[0], s[0], k, use_pallas=True).shape == (3, 8)
    assert calls == ["int8_matmul_dequant_3d", "int8_matmul_dequant",
                     "int8_matmul_dequant"]


def test_int8_wrappers_on_other_devices_go_to_the_kernel(monkeypatch,
                                                         tmp_path):
    """A tensor that is not on the CPU goes to the kernel, which here cannot
    be built: both entries raise and count no launch. Shape checks come
    first."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    i8 = dict(device="meta", dtype=torch.int8)
    w_q, w_s = torch.empty(64, 16, **i8), torch.empty(16, device="meta")
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        int8_matmul.int8_matmul_dequant(torch.empty(10, 64, **i8),
                                        torch.empty(10, device="meta"), w_q, w_s)
    with pytest.raises(_build.KernelBuildError):
        int8_matmul.int8_matmul_dequant_3d(
            torch.empty(2, 5, 64, **i8),
            torch.empty(2, 5, device="meta", dtype=torch.bfloat16), w_q, w_s,
            bias=torch.empty(16, device="meta", dtype=torch.bfloat16),
            relu=True)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_matmul.int8_matmul_dequant(torch.empty(10, 48, **i8),
                                        torch.empty(10, device="meta"),
                                        torch.empty(48, 16, **i8), w_s)
    with pytest.raises(ValueError, match="shapes"):
        int8_matmul.int8_matmul_dequant(torch.empty(10, 64, **i8),
                                        torch.empty(9, device="meta"), w_q, w_s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_matmul.int8_matmul_dequant(torch.empty(10, 64, **i8),
                                        torch.empty(10, device="meta"), w_q,
                                        w_s, out_dtype=torch.float16)


def record_launches(monkeypatch):
    """Replace ``_build.launch`` with a recorder of (kernel, entry, args)."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, device, *args:
                        calls.append((kernel, entry, args)))
    return calls


# (entry, rows or (B, G), K, N, x_scale dtype, bias, relu, out dtype): the
# path shapes, a ragged M, an M below one 128-row tile, an N that is not a
# multiple of the 256-column tile, a K below one 128-byte stage, N=8
INT8_WRAPPER_CASES = [
    ("int8_matmul_dequant", 3001, 2048, 1024, torch.float32, True, True,
     torch.float32),
    ("int8_matmul_dequant", 100, 96, 1000, torch.bfloat16, True, True,
     torch.bfloat16),
    ("int8_matmul_dequant", 64, 32, 8, torch.float32, False, False,
     torch.bfloat16),
    ("int8_matmul_dequant", 8192 * 36, 2048, 2048, torch.float32, False,
     False, torch.bfloat16),
    ("int8_matmul_dequant_3d", (1003, 36), 2048, 1024, torch.bfloat16, True,
     True, torch.bfloat16),
    ("int8_matmul_dequant_3d", (2, 5), 64, 40, torch.float32, False, False,
     torch.float32),
]


@pytest.mark.parametrize("case", INT8_WRAPPER_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_int8_wrappers_hand_the_kernel_its_operands(monkeypatch, case):
    """Off the CPU each entry passes the wgmma kernel x_q as [M, K], the
    weight K-major as a contiguous [N, K] copy, the [M] scales, and the
    flags (x_scale bf16, out bf16, ReLU) with M, K, N, for every shape the
    kernel takes: any M, K a multiple of 32, N of 8."""
    name, rows, k, n, xs_dtype, with_bias, relu, out_dtype = case
    calls = record_launches(monkeypatch)
    i8 = dict(device="meta", dtype=torch.int8)
    lead = rows if isinstance(rows, tuple) else (rows,)
    m = int(np.prod(lead))
    bias = torch.empty(n, device="meta", dtype=out_dtype) if with_bias else None
    out = getattr(int8_matmul, name)(
        torch.empty(*lead, k, **i8), torch.empty(*lead, device="meta", dtype=xs_dtype),
        torch.empty(k, n, **i8), torch.empty(n, device="meta"), bias=bias,
        relu=relu, out_dtype=out_dtype)
    assert out.shape == (*lead, n) and out.dtype == out_dtype
    [(kernel, entry, args)] = calls
    assert (kernel, entry) == (name, "int8_matmul_forward")
    x_q, x_scale, w_nk, w_scale, b, y = args[:6]
    assert x_q.shape == (m, k) and x_scale.shape == (m,)
    assert w_nk.shape == (n, k) and w_nk.is_contiguous()
    assert w_scale.shape == (n,) and y.shape == (m, n)
    assert (b is bias) if with_bias else b == 0
    assert args[6:] == (m, k, n, int(xs_dtype == torch.bfloat16),
                        int(out_dtype == torch.bfloat16), int(relu))


@pytest.mark.parametrize("k, n, match", [(48, 16, "multiple of 32"),
                                         (64, 12, "of 8"),
                                         (16, 16, "multiple of 32")])
def test_int8_wrappers_refuse_before_any_launch(monkeypatch, k, n, match):
    """What the kernel does not take (K not a multiple of 32, N not of 8)
    is refused by the wrapper: no launch is made or counted."""
    calls = record_launches(monkeypatch)
    before = dict(_build.LAUNCHES)
    i8 = dict(device="meta", dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        int8_matmul.int8_matmul_dequant(
            torch.empty(10, k, **i8), torch.empty(10, device="meta"),
            torch.empty(k, n, **i8), torch.empty(n, device="meta"))
    assert calls == [] and _build.LAUNCHES == before
