"""The plain references against the port on the CPU at a tiny size, in
float32: the Up-Down forward, the training loss and every gradient with
the same dropout masks (drawn afresh by the reference), the Philox masks,
the clip and Adamax."""

from __future__ import annotations

import pytest
import torch

from vqabench import common
from vqabench.reference import philox
from vqabench.reference import train as ref_train
from vqabench.reference import updown
from vqabench.reference.precision import Precision
from vqabench.tests.conftest import tiny


def _setup(cell):
    from vqabench.drivers import train as train_driver
    from vqabench.run import Run

    bench, c, cfg, tr = tiny(cell)
    run = Run(c, cfg, tr, 41, 0.0, False, torch.device("cpu"))
    model, weights = common.build_model(run, torch.float32)
    gen = common.generator("cpu", 41, common.INPUTS)
    return cfg, tr, model, weights, train_driver.stage(run, gen, tr["batch"])


def test_answer_logits_match_the_port():
    cfg, _, model, weights, batch = _setup("updown-answer-staged")
    model.eval()
    with torch.no_grad():
        got = model({k: batch[k] for k in ("q", "img_q", "img_scale")})[0]
        ref = updown.answer(weights, batch, Precision())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["updown-train", "vqae-train-c20"])
def test_loss_and_gradients_match_the_port_with_dropout(cell):
    from vqa_tpu_torch.training.state import backward_step

    cfg, tr, model, weights, batch = _setup(cell)
    run_seed, step = 987654321012, 2
    metrics = backward_step(model, batch, run_seed, step, compute_dtype=None)
    P = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    loss = ref_train.loss_and_grads(P, batch, run_seed, step, cfg, Precision(),
                                    5, torch.float32)
    assert abs(loss - float(metrics["loss"])) <= 1e-5 * abs(loss)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, P[name].grad, rtol=1e-4, atol=1e-6,
                                   msg=name)


def test_philox_masks_match_the_port():
    from vqa_tpu_torch.ops.kernels.decode_att import keep_mask

    for stream, (boxes, width) in enumerate([(6, 40), (1, 33), (1, 48)]):
        for t in (0, 3):
            ours = philox.keep(0xDEADBEEF, t, 5, 7, boxes, width, 205, stream,
                               "cpu")
            port = keep_mask(0xDEADBEEF, t, 7, boxes, width, 205,
                             stream=stream, row0=5)
            assert torch.equal(ours.reshape(7, -1), port.bool())


def test_keep_law():
    assert philox.keep_law(0.5) == (128, 2.0)
    assert philox.keep_law(0.2) == (205, 256 / 205)


def test_clip_and_adamax_match_torch():
    g = torch.Generator().manual_seed(1)
    params = {f"p{i}": torch.randn(5, 3, generator=g) for i in range(3)}
    ours = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    theirs = [v.clone().requires_grad_(True) for v in params.values()]
    opt_t = torch.optim.Adamax(theirs, lr=2e-3)
    opt_o = ref_train.Adamax(ours, 2e-3)
    for _ in range(3):
        grads = [torch.randn(5, 3, generator=g) * 3 for _ in params]
        for p, gr in zip(theirs, grads):
            p.grad = gr.clone()
        for p, gr in zip(ours.values(), grads):
            p.grad = gr.clone()
        torch.nn.utils.clip_grad_norm_(theirs, 0.25)
        ref_train.clip_([p.grad for p in ours.values()], 0.25)
        opt_t.step()
        opt_o.step(ours)
    for a, b in zip(ours.values(), theirs):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=1e-7)


def test_step_seeds_match_the_port():
    from vqa_tpu_torch.training.state import step_seeds

    for run_seed, step in ((0, 0), (2 ** 63 + 5, 7), (3100000001, 123)):
        assert ref_train.step_seeds(run_seed, step) == step_seeds(run_seed, step)
