"""B2, selective attention (`kernels/selective_attention`: the
tensor-core route's `attn_tc_kernel<SelectivePolicy,..>` or the SIMT
`selective_fwd_kernel`): share of its roofline over the traced window."""
from rcbench.metrics import roofline


def read(run):
    return roofline(run, "b2", "selective_fwd_kernel", "SelectivePolicy")
