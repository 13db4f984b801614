"""Stream ms a forward in the pooling of the attended features (CUDA
events around the span ``vqa.encoder.pool``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.encoder.pool")
