"""The kernels' shape gates: each kernel module's ``supports`` against its
wrapper's refusals, and each ``use_pallas`` routing site against its gate.

- On meta tensors, over a grid of shapes and types, with no ``nvcc`` (so a
  call that passes every check reaches the build and raises
  KernelBuildError there): ``supports`` holds exactly where the wrapper
  reaches the build, and where it does not the wrapper refuses with
  ValueError or TypeError.
- On the CPU, with each kernel wrapper replaced by a spy that counts its
  calls and runs the plain version: every routing site calls the wrapper
  where its gate holds, and with the gate stubbed false (or at a shape the
  kernel refuses) it takes the plain version, with the same result.
"""

import numpy as np
import pytest
import torch

from vqa_tpu_torch.models.encoder import BaseEncoder
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops import quant
from vqa_tpu_torch.ops import rnn as rnn_mod
from vqa_tpu_torch.ops.attention import MultiplyAttention
from vqa_tpu_torch.ops.embedding import WordEmbedding
from vqa_tpu_torch.ops.gcn import CorrelatedGraphConv
from vqa_tpu_torch.ops.kernels import (
    _build, decode_att, feed_gemm, fused_attention, gcn_chain, gru, gru_v2,
    gru_v3, int8_matmul, lazyv_pool, vocab_topk)
from vqa_tpu_torch.ops.rnn import SentenceEmbedding
from vqa_tpu_torch.tools.beam import make_beam_search

BF16, F32, F16, I8 = torch.bfloat16, torch.float32, torch.float16, torch.int8


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))


def meta(*shape, dtype=BF16):
    return torch.empty(*shape, device="meta", dtype=dtype)


def reaches_build(call) -> bool:
    """True where the wrapper passes its checks and asks for the build;
    False where it refuses (ValueError or TypeError)."""
    before = dict(_build.LAUNCHES)
    try:
        call()
    except _build.KernelBuildError:
        return True
    except (ValueError, TypeError):
        return False
    finally:
        assert _build.LAUNCHES == before
    raise AssertionError("the wrapper neither refused nor built")


def gru_call(fn, t_len, hidden, dtype):
    return lambda: fn(meta(8, t_len, 3 * hidden, dtype=dtype),
                      meta(hidden, 3 * hidden, dtype=dtype),
                      meta(3 * hidden, dtype=dtype))


def gru_v3_call(t_len, hidden, dtype):
    return lambda: gru_v3.gru_last_state_v3(
        meta(8, t_len, 300, dtype=dtype), meta(300, 3 * hidden, dtype=dtype),
        meta(3 * hidden, dtype=dtype), meta(hidden, 3 * hidden, dtype=dtype),
        meta(3 * hidden, dtype=dtype))


GRU_CASES = [(10, 1024, BF16), (10, 32, BF16), (10, 1000, BF16),
             (10, 20, BF16), (1, 64, BF16), (0, 64, BF16), (10, 64, F32),
             (10, 64, F16)]


@pytest.mark.parametrize("t_len, hidden, dtype", GRU_CASES)
def test_gru_supports_matches_the_wrappers(no_nvcc, t_len, hidden, dtype):
    """gru_v2, gru_last_state (v1) and gru_last_state_v3 share the sequence
    kernel's rule: a step, H a multiple of 32, bf16."""
    want = gru_v2.supports(t_len, hidden, dtype)
    assert gru.supports(t_len, hidden, dtype) == want
    assert gru_v3.supports(t_len, hidden, dtype) == want
    assert want == (t_len >= 1 and hidden % 32 == 0 and dtype == BF16)
    for call in (gru_call(gru_v2.gru_last_state_v2, t_len, hidden, dtype),
                 gru_call(gru.gru_last_state, t_len, hidden, dtype),
                 gru_v3_call(t_len, hidden, dtype)):
        assert reaches_build(call) == want


@pytest.mark.parametrize("b, n, d, dtype", [
    (4, 36, 2048, BF16), (3, 5, 16, BF16), (4, 36, 40, BF16),
    (4, 36, 2040, BF16), (4, 36, 32, F32)])
def test_pool_int8_supports_matches_the_wrapper(no_nvcc, b, n, d, dtype):
    want = lazyv_pool.supports(b, n, d, dtype)
    assert want == (d % 16 == 0 and dtype == BF16)
    assert reaches_build(lambda: lazyv_pool.pool_int8(
        meta(b, n, dtype=dtype), meta(b, n, d, dtype=I8))) == want


@pytest.mark.parametrize("m, k, n, dtype", [
    (36864, 2048, 1024, BF16), (100, 80, 1000, BF16), (10, 16, 8, BF16),
    (100, 40, 16, BF16), (100, 64, 12, BF16), (10, 64, 16, F32)])
def test_dequant_matmul_supports_matches_the_wrapper(no_nvcc, m, k, n,
                                                     dtype):
    want = feed_gemm.supports(m, k, n, dtype)
    assert want == (k % 16 == 0 and n % 8 == 0 and dtype == BF16)
    assert reaches_build(lambda: feed_gemm.dequant_matmul(
        meta(m, k, dtype=I8), meta(m, dtype=dtype),
        meta(k, n, dtype=dtype))) == want


@pytest.mark.parametrize("m, k, n, objs, dtype, gate", [
    (36864 * 32, 2048, 1024, 36, BF16, BF16), (130, 80, 1000, 10, BF16, BF16),
    (10, 16, 8, 10, BF16, BF16), (100, 40, 16, 10, BF16, BF16),
    (100, 64, 12, 10, BF16, BF16), (10, 64, 16, 10, F32, BF16),
    (10, 64, 16, 10, BF16, F32), (100, 64, 16, 36, BF16, BF16),
    (72, 64, 16, 0, BF16, BF16)])
def test_dequant_matmul_gated_logits_supports_matches_the_wrapper(
        no_nvcc, m, k, n, objs, dtype, gate):
    """The gated entry takes what dequant_matmul takes, with M a whole
    number of images of ``objs`` rows and a bf16 gate."""
    want = feed_gemm.supports_gated_logits(m, k, n, objs, dtype, gate)
    assert want == (feed_gemm.supports(m, k, n, dtype) and objs >= 1
                    and m % objs == 0 and gate == BF16)
    images = m // objs if objs else 1
    assert reaches_build(lambda: feed_gemm.dequant_matmul_gated_logits(
        meta(m, k, dtype=I8), meta(m, dtype=dtype), meta(k, n, dtype=dtype),
        meta(n, dtype=dtype), meta(images, n, dtype=gate), objs)) == want


@pytest.mark.parametrize("b, g, k, n, xs, out", [
    (8, 36, 2048, 1024, BF16, BF16), (3, 36, 96, 40, F32, F32),
    (3, 36, 80, 40, F32, BF16), (3, 36, 96, 44, F32, BF16),
    (3, 36, 96, 40, F16, BF16), (3, 36, 96, 40, F32, F16)])
def test_int8_matmul_supports_match_the_wrappers(no_nvcc, b, g, k, n, xs,
                                                 out):
    """Both entries: K a multiple of 32, N of 8, f32 or bf16 scales and
    outputs."""
    want = int8_matmul.supports(b * g, k, n, xs, out)
    assert int8_matmul.supports_3d(b, g, k, n, xs, out) == want
    assert want == (k % 32 == 0 and n % 8 == 0 and xs in (F32, BF16)
                    and out in (F32, BF16))
    w = (meta(k, n, dtype=I8), meta(n, dtype=F32))
    kw = dict(bias=meta(n, dtype=out), relu=True, out_dtype=out)
    assert reaches_build(lambda: int8_matmul.int8_matmul_dequant(
        meta(b * g, k, dtype=I8), meta(b * g, dtype=xs), *w, **kw)) == want
    assert reaches_build(lambda: int8_matmul.int8_matmul_dequant_3d(
        meta(b, g, k, dtype=I8), meta(b, g, dtype=xs), *w, **kw)) == want


@pytest.mark.parametrize("b, n, d, labels, dtype", [
    (2, 36, 2048, 12, BF16), (2, 36, 2048, 12, F32), (2, 36, 1000, 16, BF16),
    (2, 10, 2048, 12, BF16), (2, 36, 1004, 12, BF16), (2, 36, 64, 17, BF16),
    (2, 36, 64, 12, F16)])
def test_gcn_chain_supports_matches_the_wrapper(no_nvcc, b, n, d, labels,
                                                dtype):
    want = gcn_chain.supports(b, n, d, labels, dtype)
    assert want == (n == 36 and d % 8 == 0 and labels <= 16
                    and dtype in (F32, BF16))
    assert reaches_build(lambda: gcn_chain.gcn_chain_fused(
        meta(b, n, d, dtype=dtype), meta(b, n, d, dtype=dtype),
        meta(b, n, n, dtype=dtype), meta(b, n, n, dtype=torch.int32),
        meta(labels, d, dtype=dtype), num_labels=labels)) == want


@pytest.mark.parametrize("rows, hidden, vocab, k, dtype", [
    (12288, 1024, 20000, 3, BF16), (8, 1000, 1000, 8, BF16),
    (8, 1000, 5, 5, BF16), (8, 1020, 100, 3, BF16), (8, 64, 100, 9, BF16),
    (8, 64, 5, 6, BF16), (8, 64, 100, 0, BF16), (8, 64, 100, 3, F32)])
def test_vocab_topk_supports_matches_the_wrapper(no_nvcc, rows, hidden,
                                                 vocab, k, dtype):
    want = vocab_topk.supports(rows, hidden, vocab, k, dtype)
    assert want == (hidden % 8 == 0 and 1 <= k <= min(8, vocab)
                    and dtype == BF16)
    assert reaches_build(lambda: vocab_topk.vocab_topk_lse(
        meta(rows, hidden, dtype=dtype), meta(vocab, hidden),
        meta(vocab), k)) == want


@pytest.mark.parametrize("b, n, dv, h, hq, dtype", [
    (4, 36, 2048, 1024, 1024, BF16), (4, 256, 64, 1040, 24, BF16),
    (4, 257, 64, 64, 64, BF16), (4, 36, 60, 64, 64, BF16),
    (4, 36, 64, 60, 64, BF16), (4, 36, 64, 64, 60, BF16),
    (4, 36, 64, 64, 64, F32)])
def test_fused_attention_supports_matches_the_wrapper(no_nvcc, b, n, dv, h,
                                                      hq, dtype):
    want = fused_attention.supports(b, n, dv, h, hq, dtype)
    assert want == (1 <= n <= 256 and dv % 8 == 0 and h % 8 == 0
                    and hq % 8 == 0 and dtype == BF16)
    assert reaches_build(lambda: fused_attention.fused_multiply_attention_pool(
        meta(b, n, dv, dtype=dtype), meta(b, hq, dtype=dtype), meta(dv, h),
        meta(h, dtype=F32), meta(hq, h), meta(h, dtype=F32),
        meta(h, 1, dtype=F32), meta(1, dtype=F32))) == want


def decode_att_calls(batch, objs, hidden, dim, dtype, pool_dtype, offset=0):
    """The three decode-attention wrappers on one scan's meta operands;
    ``offset`` starts vp2's data that many bytes into its storage."""
    factored = pool_dtype == I8
    n = batch * objs * hidden
    vp2 = meta(n + 8, dtype=dtype)
    vp2 = (vp2.view(I8)[offset:].view(dtype) if offset else vp2)[:n]
    vp2 = vp2.view(batch, objs * hidden)
    pool2 = meta(batch, objs * dim, dtype=pool_dtype)
    w = meta(batch, objs, dtype=dtype) if factored else None
    qp, k = meta(batch, hidden, dtype=dtype), meta(hidden, dtype=dtype)
    att, g = meta(batch, objs, dtype=dtype), meta(batch, dim, dtype=dtype)
    kw = dict(objs=objs, thresh=205)
    return (lambda: decode_att.decode_att_fwd(vp2, pool2, w, qp, k, 1, 0,
                                              att_scale=1.25, **kw),
            lambda: decode_att.decode_att_bwd(vp2, pool2, w, att, g, 1, 0,
                                              **kw),
            lambda: decode_att.decode_att_dvp(
                meta(19, batch, objs, dtype=dtype),
                meta(19, batch, hidden, dtype=dtype), k, 1, att_scale=1.25,
                out_dtype=dtype, **kw))


@pytest.mark.parametrize("objs, hidden, dim, dtype, pool_dtype, offset", [
    (36, 1024, 2048, BF16, I8, 0), (36, 1024, 2048, BF16, BF16, 0),
    (5, 16, 16, F32, F32, 0), (64, 32, 48, F32, I8, 0),
    (36, 20, 2048, BF16, I8, 0), (36, 1000, 2048, BF16, I8, 0),
    (36, 1024, 2040, BF16, I8, 0), (65, 64, 64, BF16, I8, 0),
    (36, 8208, 16, BF16, I8, 0), (36, 64, 8208, BF16, I8, 0),
    (36, 64, 64, F16, F16, 0), (36, 64, 64, BF16, F32, 0),
    (36, 64, 64, BF16, I8, 2)])
def test_decode_att_supports_matches_the_wrappers(no_nvcc, objs, hidden, dim,
                                                  dtype, pool_dtype, offset):
    """``supports`` holds exactly where all three kernels take one scan's
    operands (the forward alone refuses H or D above 8192 and operands off a
    16-byte boundary)."""
    want = decode_att.supports(objs, hidden, dim, dtype, pool_dtype,
                               aligned=offset % 16 == 0)
    assert want == (hidden % 16 == 0 and dim % 16 == 0 and objs <= 64
                    and hidden <= 8192 and dim <= 8192
                    and dtype in (F32, BF16) and pool_dtype in (I8, dtype)
                    and offset % 16 == 0)
    got = [reaches_build(c) for c in decode_att_calls(4, objs, hidden, dim,
                                                      dtype, pool_dtype,
                                                      offset)]
    assert all(got) == want


# ------------------------------------------------------------ routing sites


@pytest.fixture
def spies(monkeypatch):
    """Replace kernel wrappers by spies that count their calls and run the
    plain version: ``spies(module, name[, plain])`` -> the call counter."""
    counts = {}

    def install(module, name, plain=None):
        ref = getattr(module, plain or name + "_reference")
        counts[name] = 0

        def spy(*args, **kw):
            counts[name] += 1
            return ref(*args, **kw)

        monkeypatch.setattr(module, name, spy)
        return counts

    return install


def stub_false(monkeypatch, module, name="supports"):
    monkeypatch.setattr(module, name, lambda *a, **k: False)


def test_question_gru_route(spies, monkeypatch):
    """The question GRU goes to gru_v2 where ``gru_v2.supports`` holds (H a
    multiple of 32), else to the plain scan."""
    counts = spies(gru_v2, "gru_last_state_v2")
    x = torch.randn(8, 5, 12).to(BF16)
    for hidden, calls in ((32, 1), (20, 0)):
        rnn = SentenceEmbedding(12, hidden, use_pallas=True).eval().to(BF16)
        out = rnn(x)
        assert counts["gru_last_state_v2"] == calls and out.shape == (8, hidden)
        counts["gru_last_state_v2"] = 0
    stub_false(monkeypatch, gru_v2)
    assert torch.equal(rnn(x), out) and counts["gru_last_state_v2"] == 0


@pytest.fixture
def xi_seen(monkeypatch):
    """gru_v2 replaced by its plain version, keeping each call's input
    gates xi; the route counters reset."""
    seen = []

    def spy(xi, wh, bh):
        seen.append(xi)
        return gru_v2.gru_last_state_v2_reference(xi, wh, bh)

    monkeypatch.setattr(gru_v2, "gru_last_state_v2", spy)
    rnn_mod.reset_routes()
    return seen


def question_gru(frozen=False, ntoken=30, in_dim=12, hidden=32):
    """A bf16 serving word embedding (learned: ntoken + 1 rows; a frozen
    GloVe-style table: ntoken + 4) and question GRU."""
    gen = torch.Generator().manual_seed(0)
    table = (np.random.default_rng(1).standard_normal((ntoken + 4, in_dim))
             .astype(np.float32) if frozen else None)
    emb = WordEmbedding(ntoken, in_dim, frozen_table=table, generator=gen)
    rnn = SentenceEmbedding(in_dim, hidden, use_pallas=True, generator=gen)
    return emb.eval().to(BF16), rnn.eval().to(BF16)


def within_bf16_ulp(got, want):
    """|got - want| at most one bf16 ulp of the larger magnitude."""
    got, want = got.float(), want.float()
    ulp = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("batch, t_len", [(8, 5), (8, 4), (8, 3), (16, 2)])
def test_question_table_route_matches_gates_route(xi_seen, frozen, batch,
                                                  t_len):
    """The question GRU on the kernel route forms its input gates from rows
    of the projected vocabulary table where the table has no more rows than
    the batch has tokens (learned 31 rows, frozen 34: B x T = 40 and 32
    against 24 and 32), else over every token; xi and the last state agree
    with the per-token route within bf16 rounding."""
    emb, rnn = question_gru(frozen)
    rows = emb.matrix.shape[0]
    tokens = torch.randint(0, rows, (batch, t_len),
                           generator=torch.Generator().manual_seed(2))
    route = "table" if rows <= batch * t_len else "gates"
    got = rnn.forward_tokens(tokens, emb)
    assert rnn_mod.ROUTES == {"table": int(route == "table"),
                              "gates": int(route == "gates")}
    want = rnn(emb(tokens))
    assert rnn_mod.ROUTES["gates"] == 1 + (route == "gates")
    assert got.shape == (batch, 32) and got.dtype == BF16
    assert within_bf16_ulp(xi_seen[0], xi_seen[1])
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -7)


@pytest.mark.parametrize("case, route", [
    ("serving", "table"), ("training", None), ("f32", None),
    ("batch not a multiple of 8", None), ("more rows than tokens", "gates"),
    ("kernel off", None)])
def test_question_route_rule(xi_seen, case, route):
    """The table only on the kernel route (eval, use_pallas, bf16, B % 8 ==
    0) and only where rows <= B x T; the plain scan counts no route."""
    emb, rnn = question_gru()
    batch, t_len = {"batch not a multiple of 8": (12, 5),
                    "more rows than tokens": (8, 3)}.get(case, (8, 5))
    if case == "training":
        rnn.train()
    elif case == "f32":
        emb, rnn = emb.float(), rnn.float()
    elif case == "kernel off":
        rnn.use_pallas = False
    tokens = torch.randint(0, 31, (batch, t_len),
                           generator=torch.Generator().manual_seed(3))
    out = rnn.forward_tokens(tokens, emb)
    assert rnn_mod.ROUTES == {"table": int(route == "table"),
                              "gates": int(route == "gates")}
    assert len(xi_seen) == int(route is not None)
    if route is None:
        torch.testing.assert_close(out, rnn(emb(tokens)), rtol=0, atol=0)


@pytest.mark.parametrize("ntoken, route", [(30, "table"), (50, "gates")])
def test_encoder_counts_one_question_route_a_forward(xi_seen, ntoken, route):
    """A bf16 serving encoder (B x T = 40 tokens) counts one route a forward:
    the table where the embedding has 31 rows, the gates where it has 51."""
    enc = BaseEncoder(ntoken, 32, 12, 32, att_type="new", use_pallas=True,
                      generator=torch.Generator().manual_seed(0))
    enc = enc.eval().to(BF16)
    batch = int8_batch()
    with torch.no_grad():
        for calls in (1, 2):
            enc(batch)
            assert rnn_mod.ROUTES == {"table": calls * (route == "table"),
                                      "gates": calls * (route == "gates")}


@pytest.mark.parametrize("frozen, which", [
    (False, "embedding"), (False, "weight_ih"), (True, "bias_ih")])
def test_question_table_follows_the_weights(xi_seen, frozen, which):
    """No table outlives a forward: a weight changed in place between two
    forwards changes the output, to what the per-token route gives."""
    emb, rnn = question_gru(frozen)
    tokens = torch.randint(0, 31, (8, 5),
                           generator=torch.Generator().manual_seed(4))
    first = rnn.forward_tokens(tokens, emb)
    param = {"embedding": emb.matrix, "weight_ih": rnn.rnn.weight_ih_l0,
             "bias_ih": rnn.rnn.bias_ih_l0}[which]
    with torch.no_grad():
        param.mul_(-1.5)
    second = rnn.forward_tokens(tokens, emb)
    assert rnn_mod.ROUTES == {"table": 2, "gates": 0}
    assert not torch.equal(first, second)
    torch.testing.assert_close(second.float(), rnn(emb(tokens)).float(),
                               rtol=0, atol=2.0 ** -7)


def int8_batch(batch=8, objs=6, v_dim=32):
    rng = np.random.default_rng(0)
    return {"q": torch.from_numpy(rng.integers(0, 30, (batch, 5))),
            "img_q": torch.from_numpy(rng.integers(-127, 128, (batch, objs, v_dim),
                                                   dtype=np.int8)),
            "img_scale": torch.full((batch, objs), 0.02, dtype=BF16)}


@pytest.mark.parametrize("stubs", [(), ("lazyv_pool",), ("gated",),
                                   ("gated", "lazyv_pool")])
def test_int8_feed_routes(spies, monkeypatch, stubs):
    """A bf16 serving encoder with MultiplyAttention on the int8 feed: the
    attention goes to dequant_matmul_gated_logits (the bias, ReLU and logit
    in the GEMM's epilogue) and the pooling to pool_int8 where their gates
    hold. The gated entry's gate stubbed false sends the attention to the
    plain form (the dequantized features, then the attention), never to
    the plain dequant_matmul; the pool's gate false, the pooling to its
    plain version: the same outputs."""
    counts = spies(feed_gemm, "dequant_matmul_gated_logits")
    spies(feed_gemm, "dequant_matmul")
    spies(lazyv_pool, "pool_int8")
    enc = BaseEncoder(30, 32, 8, 32, att_type="new", use_pallas=True,
                      generator=torch.Generator().manual_seed(0))
    enc = enc.eval().to(BF16)
    batch = int8_batch()
    want = enc(batch)
    assert counts == {"dequant_matmul_gated_logits": 1, "dequant_matmul": 0,
                      "pool_int8": 1}
    if stubs:
        gates = {"lazyv_pool": (lazyv_pool, "supports"),
                 "gated": (feed_gemm, "supports_gated_logits")}
        for stub in stubs:
            stub_false(monkeypatch, *gates[stub])
        for name in counts:
            counts[name] = 0
        got = enc(batch)
        for key in ("v_att", "v_w", "v_sum"):
            assert torch.equal(got[key], want[key]), key
        assert counts == {
            "dequant_matmul_gated_logits": int("gated" not in stubs),
            "dequant_matmul": 0,
            "pool_int8": int("lazyv_pool" not in stubs)}


@pytest.mark.parametrize("case", ["training", "use_int8", "concat",
                                  "training_grads"])
def test_gated_logits_route_bypassed_by_the_encoder(spies, case):
    """The fused attention runs only on the bf16 int8-feed kernel route of
    MultiplyAttention at inference: not in training mode, not with the int8
    GEMM (``use_int8``), not with ConcatAttention. In training an encoder
    without ``with_v`` gives the ``v_att``, ``v_sum`` and ``W_v`` gradient
    of the explicit dense composition, bit for bit: the dequantized
    features, the attention, the pooling."""
    counts = spies(feed_gemm, "dequant_matmul_gated_logits")
    spies(feed_gemm, "dequant_matmul")
    spies(int8_matmul, "int8_matmul_dequant_3d")
    enc = BaseEncoder(30, 32, 8, 32, att_type="base" if case == "concat" else "new",
                      use_pallas=True, use_int8=case == "use_int8",
                      generator=torch.Generator().manual_seed(0)).to(BF16)
    enc.train(case.startswith("training"))
    batch = int8_batch()
    torch.manual_seed(7)
    out = enc(batch)
    assert counts["dequant_matmul_gated_logits"] == 0
    assert counts["dequant_matmul"] == 0
    assert out["v_att"].shape == (8, 6, 1)
    assert counts["int8_matmul_dequant_3d"] == int(case == "use_int8")
    if case == "training_grads":
        img_q, img_scale = batch["img_q"], batch["img_scale"]
        weight_v = enc.attention.W_v.main[0].weight_v
        got = torch.autograd.grad(out["v_sum"].float().sum(), weight_v)[0]
        torch.manual_seed(7)
        q = enc.q_rnn.forward_tokens(batch["q"], enc.embedding)
        v_att = enc.attention(quant.dequantize(img_q, img_scale), q)
        v_sum = lazyv_pool.pool_int8_reference(
            v_att[..., 0] * img_scale, img_q)
        want = torch.autograd.grad(v_sum.float().sum(), weight_v)[0]
        assert torch.equal(out["v_att"], v_att)
        assert torch.equal(out["v_sum"], v_sum)
        assert torch.equal(got, want)


def test_gated_logits_route_bypassed_in_beam_mode(spies):
    """The encoder's int8-feed route with beam-shaped queries [B, k, q_dim]
    (a softmax over axis 2) takes the plain form, equal to the attention
    over the dequantized features; a 2-D query on the same encoder takes
    the gated entry. Neither reaches the plain dequant_matmul."""
    counts = spies(feed_gemm, "dequant_matmul_gated_logits")
    spies(feed_gemm, "dequant_matmul")
    enc = BaseEncoder(30, 32, 8, 16, att_type="new", use_pallas=True,
                      generator=torch.Generator().manual_seed(3))
    enc = enc.eval().to(BF16)
    batch = int8_batch()
    img_q, img_scale = batch["img_q"], batch["img_scale"]
    q = torch.randn(8, 3, 16).to(BF16)
    with torch.no_grad():
        got, v = enc.attend_feed(img_q, img_scale, q)
        assert got.shape == (8, 3, 6, 1)
        assert counts == {"dequant_matmul_gated_logits": 0,
                          "dequant_matmul": 0}
        assert torch.equal(v, quant.dequantize(img_q, img_scale))
        assert torch.equal(got, enc.attention(v, q))
        enc.attend_feed(img_q, img_scale, q[:, 0])
    assert counts == {"dequant_matmul_gated_logits": 1, "dequant_matmul": 0}


@pytest.mark.parametrize("stubs, want", [
    ((), "int8_matmul_dequant_3d"), (("supports_3d",), "int8_matmul_dequant"),
    (("supports_3d", "supports"), None)])
def test_int8_gemm_route(spies, monkeypatch, stubs, want):
    """int8_dot with use_pallas on [B, G, K] rows: the 3-D entry, then the
    2-D entry, then the plain version, as JAX tries supports_3d, supports,
    then XLA's dot."""
    counts = spies(int8_matmul, "int8_matmul_dequant_3d")
    spies(int8_matmul, "int8_matmul_dequant")
    x_q = torch.randint(-127, 128, (3, 36, 64), dtype=I8)
    x_scale, kernel = torch.rand(3, 36), torch.randn(64, 40)
    ref = quant.int8_dot(x_q, x_scale, kernel, use_pallas=True)
    for name in stubs:
        stub_false(monkeypatch, int8_matmul, name)
    counts.update(int8_matmul_dequant_3d=0, int8_matmul_dequant=0)
    assert torch.equal(quant.int8_dot(x_q, x_scale, kernel, use_pallas=True),
                       ref)
    assert counts == {k: int(k == want) for k in counts}


def test_gcn_chain_route(spies, monkeypatch):
    """A correlated conv at inference with use_pallas runs the chain where
    ``gcn_chain.supports`` holds (36 boxes), else the plain form, with the
    same output."""
    counts = spies(gcn_chain, "gcn_chain_fused", "gcn_chain_reference")
    conv = CorrelatedGraphConv(32, 32, use_pallas=True,
                               generator=torch.Generator().manual_seed(1)).eval()
    feature = torch.randn(2, 36, 32)
    graph = torch.randint(0, 12, (2, 36, 36))
    with torch.no_grad():
        want = conv(feature, graph)
        assert counts["gcn_chain_fused"] == 1
        stub_false(monkeypatch, gcn_chain)
        got = conv(feature, graph)
        assert counts["gcn_chain_fused"] == 1
        conv(feature[:, :10], graph[:, :10, :10])     # N=10: refused
        assert counts["gcn_chain_fused"] == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_beam_vocab_head_route(spies, monkeypatch):
    """The beam's fused vocab head goes to vocab_topk_lse where its gate
    holds, else to its plain version: the same beams."""
    counts = spies(vocab_topk, "vocab_topk_lse")
    model = set_model(encoder_type="base", predictor_type="none",
                      decoder_type="butd", ntoken=30, v_dim=32, embed_dim=8,
                      hidden_dim=32, decoder_hidden_dim=32, c_len=5,
                      att_type="new", device="cpu",
                      generator=torch.Generator().manual_seed(2))
    model = model.to(BF16).eval()
    beam = make_beam_search(model, 3, 5, 27, 28, fused_vocab=True)
    batch = int8_batch()
    tokens, scores = beam(batch)
    assert counts["vocab_topk_lse"] == 4
    stub_false(monkeypatch, vocab_topk)
    again = beam(batch)
    assert counts["vocab_topk_lse"] == 4
    assert torch.equal(again[0], tokens) and torch.equal(again[1], scores)


@pytest.mark.parametrize("hidden, stub, calls", [
    (16, False, True), (16, True, False), (20, False, False)])
def test_decode_scan_route(spies, monkeypatch, hidden, stub, calls):
    """The caption scan with pallas_att sends its steps to the
    decode-attention kernels where ``decode_att.supports`` holds, else to
    the plain tail (stubbed false, or a decoder width of 20), with the same
    loss and gradients."""
    names = ("decode_att_fwd", "decode_att_bwd", "decode_att_dvp")
    for name in names:
        counts = spies(decode_att, name)
    model = set_model(encoder_type="base", predictor_type="none",
                      decoder_type="butd", ntoken=30, v_dim=32, embed_dim=8,
                      hidden_dim=32, decoder_hidden_dim=hidden, c_len=5,
                      att_type="new", use_pallas=True, device="cpu",
                      generator=torch.Generator().manual_seed(3)).train()
    batch = dict(int8_batch(4), c=torch.randint(0, 29, (4, 5)),
                 cap_len=torch.tensor([5, 3, 4, 2]))
    batch["img_scale"] = batch["img_scale"].float()
    if stub:
        stub_false(monkeypatch, decode_att)
    loss, _ = model.get_loss(batch, seed=5)
    loss.backward()
    want = {"decode_att_fwd": 4, "decode_att_bwd": 4, "decode_att_dvp": 1}
    assert counts == {n: want[n] if calls else 0 for n in names}
    assert torch.isfinite(loss)
