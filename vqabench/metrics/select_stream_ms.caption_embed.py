"""Stream ms a max-relevance step in the gated caption embedding of every
candidate: both GRU scans, the gates, the LReLU layer and the masked max
(CUDA events around the span ``vqa.caption.embed``; part of
``select_stream_ms.candidates``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.caption.embed")
