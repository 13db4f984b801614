"""The port's max-relevance step (Q-Relevant, CONFIGS.md config 4 with the
q-cap head, the BUTD decoder and the MTL weighting) against the benchmark's
plain reference (``vqabench/reference/qrel.py``), on the CPU in float32
with the benchmark's seeded weights (``vqabench.common.make_weights`` and
the configuration's ``weight_gain``) at test widths: the candidates'
losses, the chosen captions, the loss and every gradient, without and with
dropout; three steps of ``make_train_select_step`` against the reference's
clip and Adamax; the reference's planted faults outside the tolerances;
the cell's own limits failing the float8 control, the half-batch fault and
the planted faults where the driver's program passes them; the select spans and ``select.ROWS``; ``vqabench/select_flops.py`` against
torch's FLOP counter. No JAX."""

import copy

import pytest
import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from vqa_tpu_torch import tracing
from vqa_tpu_torch.training import select
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import TrainState
from vqabench import common, manifest, select_control, select_flops
from vqabench.drivers import select_train
from vqabench.reference import qrel
from vqabench.reference.precision import Precision
from vqabench.run import Run

B, N_CAP, SEED = 6, 3, 2 ** 31 + 4242
CELL = "qcap-select-train"
TEST_DIMS = dict(ntoken=50, embed_dim=12, hidden_dim=32, decoder_hidden_dim=24,
                 v_dim=40, num_objs=6, q_len=5, c_len=7, ans_dim=20,
                 n_cap=N_CAP)
# Tolerances, float32 against float32. The program and the reference form
# the same products in other orders (the program's GRU input gates for all
# steps at once, the reference's step by step; the fusion as a sum over
# the boxes against w * sum), so their sums differ by f32 round-off that
# three 7-step GRUs and a 6-step decoder carry: measured 2e-6 of a
# gradient's norm and 1e-7 of a loss.
# - losses (the step's and each candidate's): 1e-5 relative;
# - a gradient: the norm of its difference over the larger of its norm
#   and its module's median leaf's, 1e-4 (a leaf whose gradient is itself
#   round-off, as the attention logits' biases under the softmax, is held
#   to its module's scale, as the benchmark holds it);
# - after three Adamax steps, each leaf's change: 1e-4 relative to its
#   reference change (Adamax divides by |g|, so a gradient's relative
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


def _model(cfg, dropout: bool):
    """The program's model with the benchmark's weights (f32); without
    ``dropout`` every Dropout module keeps everything."""
    run = Run(*_config()[:1], cfg, {}, SEED, 0.0, False, torch.device("cpu"))
    model, weights = common.build_model(run, torch.float32)
    for name, gain in cfg["weight_gain"].items():
        weights[name].mul_(gain)
    model.load_state_dict(weights)
    if not dropout:
        for m in model.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0
    return model.train(), weights


def _batch(cfg, seed: int, rows: int = B):
    gen = torch.Generator().manual_seed(seed)
    img_q, scales = common.features(gen, rows, cfg["num_objs"], cfg["v_dim"])
    c, cap_len = common.captions(gen, rows * N_CAP, cfg["c_len"],
                                 cfg["ntoken"], 2, cfg["c_len"])
    return {"img": img_q.float() * scales[..., None],
            "q": common.questions(gen, rows, cfg["q_len"], cfg["ntoken"]),
            "a": common.soft_scores(common.answer_ids(gen, rows,
                                                      cfg["ans_dim"]),
                                    cfg["ans_dim"]),
            "c_all": c.view(rows, N_CAP, -1),
            "cap_len_all": cap_len.view(rows, N_CAP)}


def _program_loss(model, batch, seed: int):
    """The program's loss, its candidates' losses [B, n] (from the
    predictor's output) and its chosen candidates (the caption decoder's
    input), with the gradients left in the parameters."""
    got = {}

    def keep_predict(mod, args, out):
        got["per"] = select.per_sample_bce(
            out, batch["a"].repeat_interleave(N_CAP, dim=0)).view(-1, N_CAP)

    def keep_caption(mod, args):
        got["sel"] = select_train.chosen(batch["c_all"], args[0]["c_target"])

    hooks = [model.predictor.register_forward_hook(keep_predict),
             model.generator.register_forward_pre_hook(keep_caption)]
    try:
        torch.manual_seed(seed)
        for p in model.parameters():
            p.grad = None
        loss, _ = select.get_select_loss(model, batch)
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return float(loss.detach()), got["per"].detach(), got["sel"]


def _grad_gaps(model, P):
    """Each leaf's gradient difference over the larger of its reference
    norm and its module's median leaf's (``common.relative_gaps``, the
    benchmark's rule)."""
    ref = {k: float(P[k].grad.norm()) for k in P}
    diff = {}
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        diff[k] = float((g - P[k].grad).norm())
    return common.relative_gaps(diff, dict.fromkeys(ref, 0.0), list(ref),
                                scale=ref)


def _reference(weights, batch, cfg, seed: int, fault=None):
    P = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    loss, per, sel = qrel.loss_and_grads(P, batch, seed, 0, cfg,
                                         Precision("f32"), 4, torch.float32,
                                         fault)
    return P, loss, per, sel


@pytest.mark.parametrize("dropout", [False, True])
def test_select_loss_and_gradients_match_the_reference(dropout):
    _, cfg, _ = _config()
    model, weights = _model(cfg, dropout)
    batch = _batch(cfg, 11)
    run_seed = 2 ** 40 + 9
    torch_seed, _ = qrel.ref_train.step_seeds(run_seed, 0)
    loss, per, sel = _program_loss(model, batch, torch_seed)
    rcfg = cfg if dropout else dict(cfg, dropout=0.0, att_dropout=0.0)
    P, ref_loss, ref_per, ref_sel = _reference(weights, batch, rcfg, run_seed)
    # the candidates lie far apart (the gain on c_net), so the choice is
    # not a matter of round-off: check that before comparing it
    gaps = ref_per.sort(dim=1).values
    assert float((gaps[:, 1] - gaps[:, 0]).min()) > 1e2 * LOSS_RTOL * float(
        ref_per.abs().max())
    torch.testing.assert_close(per, ref_per, rtol=LOSS_RTOL, atol=0.0)
    assert torch.equal(sel, ref_sel)
    assert len(set(sel.tolist())) > 1          # not the first every time
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    gaps = _grad_gaps(model, P)
    assert max(gaps.values()) < GRAD_TOL, max(gaps, key=gaps.get)


def test_three_select_steps_match_the_reference():
    _, cfg, _ = _config()
    model, weights = _model(cfg, True)
    batches = [_batch(cfg, 20 + s) for s in range(3)]
    opt = make_optimizer(model, lr=cfg["lr"], max_norm=cfg["max_norm"])
    run_seed = 2 ** 45 + 3
    ts = TrainState(model, opt, seed=run_seed)
    step = select.make_train_select_step(model, opt, compute_dtype=None)
    losses = [float(step(ts, b)["loss"]) for b in batches]
    ref_losses, first, after, _, _ = qrel.run_steps(
        weights, batches, run_seed, 3, cfg, Precision("f32"), 4,
        torch.float32)
    assert losses == pytest.approx(ref_losses, rel=LOSS_RTOL)
    # the leaves whose gradient is not round-off (the benchmark's rule:
    # Adamax moves the others by the sign of their round-off)
    leaves = common.moved_leaves({k: float(g.norm()) for k, g in first.items()})
    assert len(leaves) >= len(first) - 2
    params = dict(model.named_parameters())
    for k in leaves:
        err = float((params[k].detach() - after[k]).norm())
        assert err <= STEP_TOL * float((after[k] - weights[k]).norm()), k


def test_the_mtl_weights_stay_f32_in_a_bf16_step():
    """exp(-s) of the uncertainty weights in f32, as ``get_loss`` forms
    them: in bf16, exp(-0.002) rounds to 0.99609 (a step of 2**-8 below
    1), 0.2% off the weight on the VQA loss after one Adamax step."""
    _, cfg, _ = _config()
    model, _ = _model(cfg, False)
    model = model.to(torch.bfloat16)
    with torch.no_grad():
        model.log_vars.fill_(0.002)
    batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in _batch(cfg, 7).items()}
    loss, writes = select.get_select_loss(model, batch)
    s = model.log_vars.float()
    want = (torch.exp(-s[0]) * writes["train/loss"] + s[0]
            + torch.exp(-s[1]) * writes["train/cap/loss"] + s[1])
    assert loss.dtype == torch.float32
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-6)


@pytest.mark.parametrize("fault", qrel.FAULTS)
def test_a_planted_fault_reads_far_outside_the_tolerance(fault):
    _, cfg, _ = _config()
    model, weights = _model(cfg, True)
    batch = _batch(cfg, 11)
    run_seed = 2 ** 40 + 9
    torch_seed, _ = qrel.ref_train.step_seeds(run_seed, 0)
    _program_loss(model, batch, torch_seed)
    P, _, _, _ = _reference(weights, batch, cfg, run_seed, fault)
    gaps = _grad_gaps(model, P)
    assert max(gaps.values()) > FAULT_MARGIN * GRAD_TOL


@pytest.fixture(scope="module")
def driven():
    """The driver's set-up at test widths on the CPU: the program's checked
    steps on 8 questions a batch. In float32, not the cell's bfloat16: at
    8 questions a bfloat16 step's round-off is not averaged over 2048, and
    reads above the cell's limits."""
    cell, cfg, tr = _config()
    cfg["train_dtype"] = "float32"
    tr.update(batch=8, reference_rows=4,
              caption={"shortest": 2, "longest": cfg["c_len"]})
    run = Run(cell, cfg, tr, SEED, 0.0, False, torch.device("cpu"))
    return run, select_train.setup(run)


def _over(readings, limits):
    return [k for k in select_train.COMPARED if readings[k] > limits[k]]


@pytest.mark.parametrize("name, prec, fault", select_control.READINGS,
                         ids=[r[0] for r in select_control.READINGS])
def test_the_cells_limits_fail_the_control_where_the_program_passes(
        driven, name, prec, fault):
    """``vqabench.select_control``'s readings against the cell's own
    ``limits`` (what decides ``correct``), every compared number limited."""
    run, state = driven
    limits = run.traffic["limits"]
    assert set(select_train.COMPARED) == set(limits)
    assert not _over(select_train.readings(run, state, Precision("f32")),
                     limits)
    assert _over(select_train.readings(run, state, Precision(prec),
                                       fault=fault), limits), name


@pytest.mark.parametrize("profiled", [False, True])
def test_select_spans_and_rows(profiled):
    _, cfg, _ = _config()
    model, _ = _model(cfg, True)
    batch = _batch(cfg, 5)
    spans = ("vqa.select.candidates", "vqa.caption.embed", "vqa.select.pick",
             "vqa.select.caption")
    tracing.reset()
    select.reset_rows()
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            select.get_select_loss(model, batch)
        found = tracing.totals()
        for name in spans:
            assert found[name]["count"] == 1 and found[name]["host_ms"] > 0
    else:
        select.get_select_loss(model, batch)
        assert not set(tracing.totals()) & set(spans)
    assert select.ROWS == {"questions": B, "candidates": B * N_CAP}
    tracing.reset()


def _flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_select_flops_count_the_reference_products():
    """The count a question against torch's FLOP counter on the
    reference's forward. The reference computes some products the count
    leaves out, and the test adds them: each GRU's recurrent product on
    its zero first state, and the decoder's mean-feature input gates at
    every step but one (the count takes them once)."""
    _, cfg, _ = _config()
    _, weights = _model(cfg, False)
    batch = _batch(cfg, 3)
    P = {k: v.detach() for k, v in weights.items()}
    prec = Precision("f32")
    g = select_flops.group_flops(cfg)
    H, Hd, D = cfg["hidden_dim"], cfg["decoder_hidden_dim"], cfg["v_dim"]
    S = cfg["c_len"] - 1
    zero_state = lambda h: 2.0 * h * 3 * h          # noqa: E731
    with torch.no_grad():
        enc = qrel.encode(P, batch["img"], batch["q"], prec)
        assert _flops(qrel.encode, P, batch["img"], batch["q"], prec) == \
            B * (g["encoder"] + zero_state(H))
        v_proj = qrel.lrelu(P, qrel.HEAD + "v_net", enc["v"], prec)
        assert _flops(qrel.lrelu, P, qrel.HEAD + "v_net", enc["v"], prec) \
            == B * g["box"]
        c = batch["c_all"][:, 0].long()
        emb = P["encoder.embedding.weight"][c]
        assert _flops(qrel.head, P, v_proj, enc["q"], emb,
                      batch["cap_len_all"][:, 0], prec) == \
            B * (g["candidate"] + g["question_head"] + 2 * zero_state(H))
        assert _flops(qrel.caption_nll, P, enc["v"], c,
                      batch["cap_len_all"][:, 0], prec) == \
            B * (g["decoder"] + 2.0 * (S - 1) * D * 3 * Hd
                 + 2 * zero_state(Hd))
    chosen = g["encoder"] + g["box"] + g["question_head"] + g["candidate"] \
        + g["decoder"]
    assert select_flops.forward_flops(cfg) == pytest.approx(
        chosen + (N_CAP - 1) * g["candidate"])
    assert select_flops.train_flops(cfg) == pytest.approx(
        select_flops.forward_flops(cfg) + 2 * chosen)
