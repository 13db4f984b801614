"""attended_int8 (the int8 feed's attended features in one pass over the
payload, csrc/lazyv_pool.cu): its share of its roofline at the cell's
batch, %. It reads x_q [B, N, D] int8 and the box weights and scales
[B, N] bf16, and writes [B, N, D] bf16, with two products an element."""

from vqabench import roofline


def read(r):
    if r.trace is None:
        return None
    c = r.config
    B, N, D = r.traffic["batch"], c["num_objs"], c["v_dim"]
    least, _ = roofline.bound(B * N * D + 2 * B * N * D + 2 * 2 * B * N,
                              2 * B * N * D, "f32")
    return roofline.share(r, "attended_int8_kernel", least)
