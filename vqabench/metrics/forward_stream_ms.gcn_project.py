"""Stream ms a forward in the graph convolutions' GEMMs over the boxes'
features: w_self, the folded direction weight and the correlation's
``f C`` (CUDA events around the span ``vqa.gcn.project``; part of
``forward_stream_ms.graph``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.gcn.project")
