"""Host ms a training step in the caption decode scan, forward and
backward (the spans ``vqa.decode_scan.forward`` and ``.backward``; part of
the step's forward and backward, not added to them)."""

from vqabench import spans


def read(r):
    return spans.per_step(r, "host_ms", "vqa.decode_scan.forward",
                          "vqa.decode_scan.backward")
