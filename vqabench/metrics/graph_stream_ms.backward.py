"""Stream ms a training step in GCN-LSTM's graph stage, backward: from
the gradient's arrival at the stage's output to the completion of its
input's gradient (CUDA events of the span ``vqa.encoder.graph.backward``;
a program without it reads nothing)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.encoder.graph.backward")
