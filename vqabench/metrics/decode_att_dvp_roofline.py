"""decode_att_dvp (csrc/decode_att.cu, the deferred gradient of the
decoder's v-projection, one a step over its c_len - 1 caption steps): its
share of its roofline at the cell's batch, %."""

from vqabench import roofline


def read(r):
    c = r.config
    least, _ = roofline.decode_att_dvp(c["c_len"] - 1, r.traffic["batch"],
                                       c["num_objs"], c["decoder_hidden_dim"])
    return roofline.share(r, "decode_att_dvp_kernel", least)
