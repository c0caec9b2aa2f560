"""B4, block gather (`kernels/block_gather`, `block_gather_kernel`: the
selective passes' assembly with RoPE realignment and layer 0's copies):
share of its roofline over the traced window."""
from rcbench.metrics import roofline


def read(run):
    return roofline(run, "b4", "block_gather_kernel")
