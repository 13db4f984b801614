"""Host ms a training step in the learning rate, the clip and Adamax (the
span ``vqa.step.optimizer``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "host_ms", "vqa.step.optimizer")
