"""Stream ms a forward in ReGAT's graph stage: the relation branches and
their sum (CUDA events around the span ``vqa.encoder.graph``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.encoder.graph")
