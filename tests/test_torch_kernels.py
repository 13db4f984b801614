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
from vqa_tpu_torch.ops.kernels import _build, feed_gemm, gru_v2, lazyv_pool

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
    with pytest.raises(ValueError, match="multiple of 64"):
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
