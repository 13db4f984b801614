"""Stream ms a forward in the answer head (CUDA events around the span
``vqa.predictor``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.predictor")
