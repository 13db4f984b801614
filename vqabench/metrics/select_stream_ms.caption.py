"""Stream ms a max-relevance step in the chosen caption's decoder: the
teacher-forced BUTD forward and its cross-entropy (CUDA events around the
span ``vqa.select.caption``)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "stream_ms", "vqa.select.caption")
