"""B3, paged decode attention (`kernels/paged_attention`,
`paged_decode_split_kernel`): share of its roofline over the traced
window."""
from rcbench.metrics import roofline


def read(run):
    return roofline(run, "b3", "paged_decode")
