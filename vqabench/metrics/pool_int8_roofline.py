"""pool_int8 (lazy-v pooling over the int8 payload, csrc/lazyv_pool.cu):
its share of its roofline at the cell's batch, %."""

from vqabench import roofline


def read(r):
    c = r.config
    least, _ = roofline.pool_int8(r.traffic["batch"], c["num_objs"], c["v_dim"])
    return roofline.share(r, "pool_int8_kernel", least)
