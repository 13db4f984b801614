"""Host ms a training step in the gradient reset and ``loss.backward()``
(the span ``vqa.step.backward``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "host_ms", "vqa.step.backward")
