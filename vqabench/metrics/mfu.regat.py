"""Model FLOPs of the ReGAT answers of the traced window a second, over
the card's bf16 peak, %: Up-Down's products and the graph stage's, the
latter in their folded form (``vqabench/graph_roofline.py`` says why)."""

from vqabench import graph_roofline, roofline


def read(r):
    if r.trace is None:
        return None
    return roofline.mfu(r, graph_roofline.answer_flops(r.config))
