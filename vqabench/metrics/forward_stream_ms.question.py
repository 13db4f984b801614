"""Stream ms a forward in the question encoder: embedding, question GRU
and ``q_net`` (CUDA events around the span ``vqa.encoder.question``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.encoder.question")
