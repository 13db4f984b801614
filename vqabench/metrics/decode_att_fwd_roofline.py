"""decode_att_fwd (csrc/decode_att.cu, one a caption step): its share of
its roofline at the cell's batch, over the int8 payload, %."""

from vqabench import roofline


def read(r):
    c = r.config
    least, _ = roofline.decode_att_fwd(r.traffic["batch"], c["num_objs"],
                                       c["decoder_hidden_dim"], c["v_dim"])
    return roofline.share(r, "decode_att_fwd_kernel", least)
