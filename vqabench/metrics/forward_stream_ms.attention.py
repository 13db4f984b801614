"""Stream ms a forward in the top-down attention: the v projection, the
logits and softmax, the box weights (CUDA events around the span
``vqa.encoder.attention``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.encoder.attention")
