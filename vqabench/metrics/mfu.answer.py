"""Model FLOPs of the questions answered in the traced window a second,
over the card's bf16 peak, %."""

from vqabench import roofline


def read(r):
    return roofline.mfu(r, roofline.answer_flops(r.config))
