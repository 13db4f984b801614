"""The port's bench (``python -m vqa_tpu_torch.bench``) and entry point
(``vqa_tpu_torch.entry``) on the CPU, against the root ``bench.py`` and
``__graft_entry__.py``.

The ladder runs as a subprocess at tiny dims (the ``VQA_BENCH_*``
variables) and prints one line in the root bench's schema; its chain, at
tiny f32 dims in this process, gives the JAX chain's logits and ids on the
same numpy batch with weights converted by ``tools/convert.py``; its
staging quantizes as ``data.quantize_features`` does; it has no fallback;
``entry()`` at full dims gives ``__graft_entry__.entry()``'s logits.
"""

import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
from __graft_entry__ import entry as jax_entry
from vqa_tpu_torch import bench
from vqa_tpu_torch.data.shards import quantize_features
from vqa_tpu_torch.entry import entry
from vqa_tpu_torch.tools.convert import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(BATCH=8, REPS=2, ITERS=1, NTOKEN=64, ANS=16, VDIM=32, HIDDEN=16,
            EMBED=12, OBJS=6)
METRIC = "vqa_updown_batch_inference_questions_per_sec_per_chip"


def run_bench(extra=None):
    env = dict(os.environ, **{f"VQA_BENCH_{k}": str(v) for k, v in TINY.items()},
               **(extra or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "vqa_tpu_torch.bench", "--device", "cpu"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def rung_lines(stderr: str):
    return [json.loads(line.split("] rung ", 1)[1]) for line in stderr.splitlines()
            if "] rung {" in line]


def test_bench_prints_one_line_in_the_root_schema():
    proc = run_bench()
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["metric"] == METRIC
    assert result["unit"] == "questions/s"
    assert result["value"] > 0
    assert result["vs_baseline"] == round(result["value"] / 25000, 3)
    rungs = rung_lines(proc.stderr)
    assert [r["rung"] for r in rungs] == ["medium", "fast32", "fast", "safe"]
    assert {r["rung"]: r["batch"] for r in rungs} == {
        "medium": 8, "fast32": 32768, "fast": 8, "safe": 8}
    # on the CPU the wrappers run their plain versions: no launch, no peak
    for r in rungs:
        assert r["peak_bytes"] is None and not any(r["launches"].values())
        assert r["qps"] > 0 and r["ms_per_forward"] > 0 and r["staging_s"] >= 0
    assert max(r["qps"] for r in rungs) == pytest.approx(result["value"], abs=0.06)


@pytest.fixture
def tiny(monkeypatch):
    """The bench's module constants at tiny f32 dims (in this process)."""
    for name, value in dict(NTOKEN=64, ANS_DIM=16, NUM_OBJS=6, V_DIM=32, Q_LEN=5,
                            EMBED_DIM=12, HIDDEN_DIM=16, REPS=3).items():
        monkeypatch.setattr(bench, name, value)
        monkeypatch.setattr(jax_bench, name, value)


def twins():
    """The root bench's JAX model (``_build_model``, the plain route) with
    its init and the port's ``safe`` model with the same weights."""
    jm = jax_bench._build_model(use_pallas=False)
    dummy = {"q": jnp.zeros((4, bench.Q_LEN), jnp.int32),
             "img": jnp.zeros((4, bench.NUM_OBJS, bench.V_DIM), jnp.float32)}
    params = jm.init(jax.random.key(0), dummy)["params"]
    port = bench.build_model("safe", torch.device("cpu"))
    port.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, port


def jax_chain(jm, params, batch):
    """The root bench's ``infer_chain`` (bench.py:324-331)."""
    def step(i, c):
        b = dict(batch, q=(batch["q"] + c[:, None]) % jax_bench.NTOKEN)
        predict, _ = jm.apply({"params": params}, b)
        return jnp.argmax(predict, axis=1).astype(jnp.int32)
    return jax.lax.fori_loop(0, jax_bench.REPS, step,
                             jnp.zeros((batch["q"].shape[0],), jnp.int32))


def numpy_batch(rng, b: int, int8: bool):
    q = rng.integers(0, bench.NTOKEN, (b, bench.Q_LEN)).astype(np.int32)
    x = rng.standard_normal((b, bench.NUM_OBJS, bench.V_DIM)).astype(np.float32)
    if not int8:
        return {"q": q, "img": x}
    img_q, scale = quantize_features(x)
    return {"q": q, "img_q": img_q, "img_scale": scale}


def test_safe_chain_matches_the_root_bench_chain(tiny):
    jm, params, port = twins()
    nb = numpy_batch(np.random.default_rng(3), 16, int8=False)
    tb = {"q": torch.from_numpy(nb["q"]).long(), "img": torch.from_numpy(nb["img"])}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    with torch.inference_mode():
        got = port(tb)[0].numpy()
        ids = bench.infer_chain(port, tb).numpy()
    want = np.asarray(jm.apply({"params": params}, jb)[0])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    want_ids = np.asarray(jax_chain(jm, params, jb))
    np.testing.assert_array_equal(ids, want_ids)
    # the chain really perturbs: a one-link chain ends elsewhere somewhere
    assert (ids != np.argmax(want, axis=1)).any()


def test_int8_feed_in_f32_matches_the_root_bench_model(tiny):
    jm, params, port = twins()
    nb = numpy_batch(np.random.default_rng(4), 16, int8=True)
    tb = {"q": torch.from_numpy(nb["q"]).long(), "img_q": torch.from_numpy(nb["img_q"]),
          "img_scale": torch.from_numpy(nb["img_scale"])}
    with torch.inference_mode():
        got = port(tb)[0].numpy()
    want = np.asarray(jm.apply({"params": params},
                               {k: jnp.asarray(v) for k, v in nb.items()})[0])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_dense_staging_quantizes_as_the_data_layer(tiny):
    # quantize alone, with exact midpoints of the rounding planted in a box
    # whose absmax is 127 (scale 1): half to even, as np.rint
    x = torch.randn((16, bench.NUM_OBJS, bench.V_DIM), generator=torch.Generator().manual_seed(5))
    x[0, 0] = 0.0
    x[0, 0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    img_q, scales = bench.quantize(x)
    want_q, want_scales = quantize_features(x.numpy())
    np.testing.assert_array_equal(img_q.numpy(), want_q)
    np.testing.assert_array_equal(scales.numpy(), want_scales)
    assert img_q[0, 0, :4].tolist() == [127, 2, -4, 0]
    # the staged batch: its x drawn after q from the same generator
    batch = bench.stage_batch("fast", 16, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    torch.randint(0, bench.NTOKEN, (16, bench.Q_LEN), generator=gen)
    want_q, want_scales = quantize_features(
        torch.randn((16, bench.NUM_OBJS, bench.V_DIM), generator=gen).numpy())
    assert batch["img_q"].dtype == torch.int8 and batch["img_scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(batch["img_q"].numpy(), want_q)
    np.testing.assert_array_equal(
        batch["img_scale"].float().numpy(),
        want_scales.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_a_failing_rung_fails_the_run_without_a_line(tiny, monkeypatch, capsys):
    ran = []

    def run_config(cfg, device):
        ran.append(cfg)
        if cfg == "fast32":
            raise torch.cuda.OutOfMemoryError("out of memory at B=32768")
        return {"rung": cfg, "qps": 1.0}

    monkeypatch.setattr(bench, "run_config", run_config)
    assert bench.main(["--device", "cpu"]) == 1
    assert ran == ["medium", "fast32"]
    out = capsys.readouterr()
    assert out.out == "" and "OutOfMemoryError" in out.err


def test_without_a_card_the_run_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_entry_matches_the_jax_entry_point():
    fn, (jparams, jbatch) = jax_entry()
    want = np.asarray(jax.jit(fn)(jparams, jbatch))
    forward, (params, batch) = entry("cpu")
    for key in ("img", "q", "a"):
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(jbatch[key]))
    converted = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(converted) == set(params)
    with torch.inference_mode():
        got = forward(converted, batch)
        own = forward(params, batch)
    assert got.shape == own.shape == (32, 3129)
    assert torch.isfinite(own).all()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
