"""Stream ms a training step in GCN-LSTM's graph stage, forward: the
relation branches and their sum, read as ``forward_stream_ms.graph``
reads them (CUDA events around the span ``vqa.encoder.graph``)."""

from vqabench import manifest

read = manifest.reader("forward_stream_ms.graph")
