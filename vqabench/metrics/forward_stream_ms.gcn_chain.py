"""Stream ms a forward in the correlated convolutions' graph-local chain:
the [36, 36] correlation products, their ReLU and ``gcn_chain_fused`` or
its plain form (CUDA events around the span ``vqa.gcn.chain``; part of
``forward_stream_ms.graph``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.gcn.chain")
