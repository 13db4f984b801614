"""gru_v2 (the question GRU, csrc/gru.cu ``gru_seq_kernel``): its share
of its roofline at the cell's batch, %."""

from vqabench import roofline


def read(r):
    c = r.config
    least, _ = roofline.gru_v2(r.traffic["batch"], c["q_len"], c["hidden_dim"])
    return roofline.share(r, "gru_seq_kernel", least)
