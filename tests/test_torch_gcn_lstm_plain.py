"""The port's GCN-LSTM training (the relation encoder with one correlated
graph convolution over the spatial graph, under the BUTD caption decoder
and its caption loss alone) against the benchmark's plain reference
(``vqabench/reference/gcn_lstm.py``), on the CPU in float32 with the
benchmark's seeded weights, inputs and spatial graphs at test widths: the
loss and every gradient, without and with dropout; three steps of
``make_train_step`` against the reference's clip and Adamax; the
reference's planted faults outside the tolerances; the cell's own limits
failing the float8 control, the half-batch fault and the faults where the
driver's program passes them; the span ``vqa.encoder.graph.backward`` and
``gcn.ROUTES``, untraced and traced; ``vqabench/gcn_lstm_flops.py``
against torch's FLOP counter. No JAX."""

import contextlib
import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vqa_tpu_torch import tracing
from vqa_tpu_torch.ops import gcn
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import TrainState, make_train_step
from vqabench import common, gcn_lstm_flops, graph_control, graph_roofline, manifest
from vqabench.drivers import graph_train, staged_regat
from vqabench.reference import gcn_lstm, regat, updown
from vqabench.reference import train as ref_train
from vqabench.reference.precision import Precision
from vqabench.run import Run

B, SEED = 6, 2 ** 31 + 2727
CELL = "gcn-lstm-train"
# the configuration at test widths: 36 boxes as published (the fused
# chain, which the eval route takes, holds 36 only), narrow features
TEST_DIMS = dict(ntoken=50, embed_dim=12, hidden_dim=32, decoder_hidden_dim=24,
                 v_dim=40, q_len=5, c_len=7)
# Tolerances, float32 against float32. The program folds w0 + w1 into one
# weight and sums the label bias by counts, forms the question GRU's input
# gates for all steps at once and the decoder's steps in its own scan,
# so its f32 sums round in other orders than the reference's: measured
# 1e-6 of a gradient's norm and 1e-7 of the loss.
# - loss: 1e-5 relative;
# - a gradient: the norm of its difference over the larger of its norm
#   and its module's median leaf's, 1e-4 (the benchmark's scale, which
#   holds a leaf whose gradient is itself round-off, as the attention
#   logits' biases under the softmax, to its module's);
# - after three Adamax steps, each moved leaf's change: 1e-4 relative to
#   its reference change (Adamax divides by |g|, so a gradient's relative
#   error passes into the update unscaled).
LOSS_RTOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-4
# a planted fault must read at least this many gradient tolerances off
FAULT_MARGIN = 100


def _config():
    bench = manifest.load()
    cell = manifest.cell(bench, CELL)
    cfg = copy.deepcopy(manifest.config(bench, cell["config"]))
    cfg.update(TEST_DIMS)
    return cell, cfg, copy.deepcopy(manifest.traffic(cell["traffic"]))


def _model(cfg):
    """The driver's model (the relation keys passed on) with the
    benchmark's weights, f32, in training mode."""
    run = Run(_config()[0], cfg, {}, SEED, 0.0, False, torch.device("cpu"))
    model, weights = staged_regat.build_model(run, torch.float32)
    return model.train(), weights


def _batch(cfg, seed: int, rows: int = B):
    cell, _, tr = _config()
    tr["caption"] = {"shortest": 2, "longest": cfg["c_len"]}
    run = Run(cell, cfg, tr, SEED, 0.0, False, torch.device("cpu"))
    return graph_train.stage(run, torch.Generator().manual_seed(seed), rows)


def _count(batch) -> torch.Tensor:
    steps = batch["c"].shape[1] - 1
    return torch.clamp(batch["cap_len"].long() - 1, 0, steps).sum().float()


def _grad_gaps(model, P):
    """Each leaf's gradient difference over the larger of its reference
    norm and its module's median leaf's (``common.relative_gaps``, the
    benchmark's rule), over the leaves that a loss reaches."""
    def grad(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    ref = {k: float(grad(P[k]).norm()) for k in P}
    leaves = [k for k, v in ref.items() if v > 0]
    diff = {k: float((grad(p) - grad(P[k])).norm())
            for k, p in model.named_parameters()}
    return common.relative_gaps(diff, dict.fromkeys(ref, 0.0), leaves,
                                scale=ref)


def _params(weights):
    return {k: v.clone().requires_grad_(True) for k, v in weights.items()}


@pytest.mark.parametrize("dropout", [False, True])
def test_loss_and_gradients_match_the_reference(dropout):
    _, cfg, _ = _config()
    if not dropout:
        cfg.update(dropout=0.0, att_dropout=0.0)
    model, weights = _model(cfg)
    batch = _batch(cfg, 11)
    run_seed = 2 ** 40 + 9
    torch_seed, scan_seed = ref_train.step_seeds(run_seed, 0)
    torch.manual_seed(torch_seed)
    loss, _ = model.get_loss(batch, seed=scan_seed)
    loss.backward()
    P = _params(weights)
    if dropout:
        ref_loss = gcn_lstm.loss_and_grads(P, batch, run_seed, 0, cfg,
                                           Precision("f32"), 4, torch.float32)
    else:
        nll, _ = gcn_lstm.caption_nll(P, batch, Precision("f32"))
        (nll / _count(batch)).backward()
        ref_loss = float(nll.detach() / _count(batch))
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    # the question's q_net, the VQA head's input, feeds no loss: the
    # program gives it no gradient, and the reference a zero one
    assert {k for k, p in model.named_parameters() if p.grad is None} == \
        {k for k in weights if k.startswith("encoder.q_net.")}
    gaps = _grad_gaps(model, P)
    assert max(gaps.values()) < GRAD_TOL, max(gaps, key=gaps.get)


def test_the_references_convolution_is_regats():
    _, cfg, _ = _config()
    _, weights = _model(cfg)
    batch = _batch(cfg, 3)
    f = torch.randn(B, cfg["num_objs"], cfg["v_dim"],
                    generator=torch.Generator().manual_seed(1)) / 36
    assert torch.equal(gcn_lstm.graph_conv(weights, f, batch["graph"],
                                           Precision("f32")),
                       regat.graph_conv(weights, f, batch["graph"],
                                        Precision("f32")))


def test_three_steps_match_the_reference():
    _, cfg, _ = _config()
    model, weights = _model(cfg)
    batches = [_batch(cfg, 20 + s) for s in range(3)]
    opt = make_optimizer(model, lr=cfg["lr"], max_norm=cfg["max_norm"])
    run_seed = 2 ** 45 + 3
    ts = TrainState(model, opt, seed=run_seed)
    step = make_train_step(model, opt, compute_dtype=None)
    losses = [float(step(ts, b)["loss"]) for b in batches]
    ref_losses, first, after = gcn_lstm.run_steps(
        weights, batches, run_seed, 3, cfg, Precision("f32"), 4,
        torch.float32)
    assert losses == pytest.approx(ref_losses, rel=LOSS_RTOL)
    # the leaves whose gradient is not round-off (the benchmark's rule:
    # Adamax moves the others by the sign of their round-off)
    leaves = common.moved_leaves({k: float(g.norm()) for k, g in first.items()})
    assert not any(k.startswith("encoder.q_net") for k in leaves)
    assert any(k.startswith("encoder.spatial_encoder") for k in leaves)
    params = dict(model.named_parameters())
    for k in leaves:
        err = float((params[k].detach() - after[k]).norm())
        assert err <= STEP_TOL * float((after[k] - weights[k]).norm()), k


@pytest.mark.parametrize("fault", gcn_lstm.FAULTS)
def test_a_planted_fault_reads_far_outside_the_tolerance(fault):
    _, cfg, _ = _config()
    model, weights = _model(cfg)
    batch = _batch(cfg, 11)
    run_seed = 2 ** 40 + 9
    torch_seed, scan_seed = ref_train.step_seeds(run_seed, 0)
    torch.manual_seed(torch_seed)
    model.get_loss(batch, seed=scan_seed)[0].backward()
    P = _params(weights)
    gcn_lstm.loss_and_grads(P, batch, run_seed, 0, cfg, Precision("f32"), 4,
                            torch.float32, fault)
    gaps = _grad_gaps(model, P)
    assert max(gaps.values()) > FAULT_MARGIN * GRAD_TOL


@pytest.fixture(scope="module")
def driven():
    """The driver's set-up at test widths on the CPU: the program's checked
    steps on 8 captions a batch. In float32, not the cell's bfloat16: at 8
    rows a bfloat16 step's round-off is not averaged over 4096."""
    cell, cfg, tr = _config()
    cfg["train_dtype"] = "float32"
    tr.update(batch=8, reference_rows=4,
              caption={"shortest": 2, "longest": cfg["c_len"]})
    run = Run(cell, cfg, tr, SEED, 0.0, False, torch.device("cpu"))
    return run, graph_train.setup(run)


def _over(readings, limits):
    return [k for k in graph_train.COMPARED if readings[k] > limits[k]]


@pytest.mark.parametrize("name, prec, fault", graph_control.READINGS,
                         ids=[r[0] for r in graph_control.READINGS])
def test_the_cells_limits_fail_the_control_where_the_program_passes(
        driven, name, prec, fault):
    """``vqabench.graph_control``'s readings against the cell's own
    ``limits`` (what decides ``correct``), every compared number limited."""
    run, state = driven
    limits = run.traffic["limits"]
    assert set(graph_train.COMPARED) == set(limits)
    assert not _over(graph_train.readings(run, state, Precision("f32")),
                     limits)
    assert _over(graph_train.readings(run, state, Precision(prec),
                                      fault=fault), limits), name


@pytest.mark.parametrize("profiled", [False, True])
def test_graph_backward_span_and_routes(profiled):
    """Untraced, the encoder registers no hook on its output and no span
    is recorded; under a profiler the training forward's backward records
    the span once, and a forward without grad, as the serving forward,
    registers nothing. Training takes the plain
    route, the eval forward with ``use_pallas`` the fused chain."""
    _, cfg, _ = _config()
    model, _ = _model(cfg)
    batch = _batch(cfg, 5)
    tracing.reset()
    gcn.reset_routes()
    ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
        else contextlib.nullcontext())
    with ctx:
        v = model.encoder(batch)["v"]
        assert bool(v._backward_hooks) == profiled
        v.sum().backward()
        with torch.no_grad():
            assert model.encoder(batch)["v"].grad_fn is None
        model.eval()
        with torch.inference_mode():      # make_infer_step's serving forward
            assert model.encoder(batch)["v"].grad_fn is None
    found = tracing.totals()
    if profiled:
        assert found["vqa.encoder.graph.backward"]["count"] == 1
        assert found["vqa.encoder.graph.backward"]["host_ms"] > 0
        assert found["vqa.encoder.graph"]["count"] == 3
    else:
        assert not set(found) & {"vqa.encoder.graph",
                                 "vqa.encoder.graph.backward"}
    assert gcn.ROUTES == {"plain": 2, "fused": 1}
    tracing.reset()
    gcn.reset_routes()


def _flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_gcn_lstm_flops_count_the_reference_products():
    """The count a sample against torch's FLOP counter on the reference's
    forward, by part. The reference computes products the count leaves
    out, and the test adds them: Up-Down's pooling and ``q_net`` (the VQA
    head's), and the graph stage unfolded (``w0`` and ``w1`` apart, ``Wa``
    and ``Wb`` apart, adj @ each direction) with its label bias as a
    gather, not a product."""
    _, cfg, _ = _config()
    _, weights = _model(cfg)
    batch = _batch(cfg, 3)
    P = {k: v.detach() for k, v in weights.items()}
    prec = Precision("f32")
    H, D, N, L = (cfg["hidden_dim"], cfg["v_dim"], cfg["num_objs"],
                  cfg["num_labels"])
    parts = gcn_lstm_flops.products(cfg)
    flops = [gcn_lstm_flops._sum([r], False) for r in parts]
    E = gcn_lstm_flops.ENCODER_PRODUCTS
    G = len(gcn_lstm_flops.graph_products(cfg))
    encoder, decoder, graph = sum(flops[:E]), sum(flops[E:-G]), sum(flops[-G:])
    with torch.no_grad():
        enc = updown.encode(P, batch, prec)
        assert _flops(updown.encode, P, batch, prec) == B * (
            encoder + 2.0 * N * D + 2.0 * H * H)
        f = enc["att"][..., None] * enc["feats"]
        assert _flops(gcn_lstm.graph_conv, P, f, batch["graph"], prec) == \
            B * (graph + 2 * 2.0 * N * D * D + 2.0 * N * N * D
                 - 2.0 * N * L * D)
        unit = {"att": torch.ones(B, N), "feats": f}
        assert _flops(updown.caption_nll, P, unit, batch, prec) == B * decoder
    assert graph == graph_roofline.graph_flops(cfg)
    # the backward: once more for each operand that takes a gradient
    grads = sum(2.0 * c * m * k * n * (dx + dw)
                for c, m, k, n, dx, dw in parts)
    assert gcn_lstm_flops.train_flops(cfg) == pytest.approx(
        gcn_lstm_flops.forward_flops(cfg) + grads)
