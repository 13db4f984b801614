"""Model FLOPs of the questions trained in the traced window a second,
over the card's bf16 peak, %: the max-relevance step's products as
``vqabench/select_flops.py`` counts them."""

from vqabench import roofline, select_flops


def read(r):
    if r.trace is None:
        return None
    return roofline.mfu(r, select_flops.train_flops(r.config))
