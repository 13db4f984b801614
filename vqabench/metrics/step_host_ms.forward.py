"""Host ms a training step in the loss's forward under ``functional_call``
(the span ``vqa.step.forward``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "host_ms", "vqa.step.forward")
