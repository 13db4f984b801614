"""Model FLOPs (forward and backward) of the samples trained in the
traced window a second, over the card's bf16 peak, %."""

from vqabench import roofline


def read(r):
    cap = r.traffic.get("caption")
    steps = r.config["c_len"] - 1 if cap else 0
    return roofline.mfu(r, roofline.train_flops(r.config, steps))
