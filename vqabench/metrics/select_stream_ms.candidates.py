"""Stream ms a max-relevance step in the candidates' forward: the
expansion of the attended features and the question, the embedding of
every candidate caption and the q-cap head over all of them (CUDA events
around the span ``vqa.select.candidates``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.select.candidates")
