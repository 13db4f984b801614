"""Host ms a training step in the cast of the f32 masters, the buffers and
the batch to the compute dtype (the span ``vqa.step.cast``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "host_ms", "vqa.step.cast")
