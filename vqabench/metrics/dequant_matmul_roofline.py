"""dequant_matmul (the int8 feed's v-projection, csrc/feed_gemm.cu): its
share of its roofline at the cell's batch, %."""

from vqabench import roofline


def read(r):
    c = r.config
    least, _ = roofline.dequant_matmul(r.traffic["batch"] * c["num_objs"],
                                       c["v_dim"], c["hidden_dim"])
    return roofline.share(r, "dequant_matmul_kernel", least)
