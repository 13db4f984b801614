"""Runs with the timed path broken underneath, the card's check skipped
(tiny sizes on the CPU): ``correct`` must come out false for each fault
that a cell can have. An answering cell: an answer altered where it is
produced; half of the batch left out. A training cell: a step that leaves
its state unchanged; half of the batch left out, the mean taken over the
rest; with a caption decoder, each decode-attention backward kernel
writing zeros. (No cell spans chips, so none can leave out an exchange.)"""

from __future__ import annotations

import pytest
import torch

from vqabench import control
from vqabench.tests.conftest import run_tiny

ANSWER = ["updown-answer-staged"]
TRAIN = ["updown-train", "vqae-train-c20"]


def _forward_fault(monkeypatch, fault):
    """Break the VQA head, which the staged forward runs."""
    from vqa_tpu_torch.models.predictor import BasePredictor

    forward = BasePredictor.forward

    def broken(self, embed):
        predict = forward(self, embed)
        if fault == "altered":
            return torch.roll(predict, 1, dims=1)
        predict = predict.clone()
        predict[predict.shape[0] // 2:] = 0
        return predict

    monkeypatch.setattr(BasePredictor, "forward", broken)


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("cell", ANSWER)
def test_an_answering_fault_is_not_correct(cell, fault, monkeypatch, cpu_threads):
    assert run_tiny(cell)["correct"] is True
    _forward_fault(monkeypatch, fault)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        cell, monkeypatch, cpu_threads):
    from vqa_tpu_torch.training.optim import Optimizer

    step = Optimizer.step

    def lost(self, update):
        before = [p.detach().clone() for p in self.params]
        norm = step(self, update)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(b)
        return norm

    monkeypatch.setattr(Optimizer, "step", lost)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_not_correct(cell, monkeypatch,
                                                   cpu_threads):
    from vqa_tpu_torch.training import state as state_mod

    backward = state_mod.backward_step

    def half(model, batch, *args, **kwargs):
        rows = batch["q"].shape[0] // 2
        return backward(model, {k: v[:rows] for k, v in batch.items()},
                        *args, **kwargs)

    monkeypatch.setattr(state_mod, "backward_step", half)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("fault", sorted(control.ZEROED_KERNELS))
def test_a_decode_attention_backward_writing_zeros_is_not_correct(
        fault, cpu_threads):
    with control.planted(fault):
        assert run_tiny("vqae-train-c20")["correct"] is False
