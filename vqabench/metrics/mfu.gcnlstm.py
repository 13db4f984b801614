"""Model FLOPs (forward and backward) of the GCN-LSTM samples trained in
the traced window a second, over the card's bf16 peak, %: the products
as ``vqabench/gcn_lstm_flops.py`` counts them, the graph stage folded."""

from vqabench import gcn_lstm_flops, roofline


def read(r):
    if r.trace is None:
        return None
    return roofline.mfu(r, gcn_lstm_flops.train_flops(r.config))
