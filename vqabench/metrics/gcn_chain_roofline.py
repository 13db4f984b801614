"""gcn_chain_fused (csrc/gcn_chain.cu, ``gcn_chain_bf16_kernel`` in bf16,
one a graph convolution): its share of its roofline at the cell's batch,
%."""

from vqabench import graph_roofline, roofline


def read(r):
    if r.trace is None:
        return None
    c = r.config
    least, _ = graph_roofline.gcn_chain(r.traffic["batch"], c["num_objs"],
                                        c["v_dim"], c["num_labels"])
    return roofline.share(r, "gcn_chain", least)
