"""The whole step's share of the chip's bf16 peak: the model FLOPs of
the prefills finished and the decode tokens emitted in the traced
window (layer 0 over every prompt token, layers 1..L-1 over the
recompute set, attention over the live keys, the head at each sampled
position, the decode tokens), over the window at 989 TFLOP/s, in %."""
from rcbench.counts import peaks
from rcbench.metrics import window_work


def read(run):
    if run.trace is None or not run.trace.events or run.trace.window_s <= 0:
        return None
    w = window_work(run)
    if w.model_flops <= 0:
        return None
    return 100.0 * w.model_flops / (run.trace.window_s * peaks.BF16_FLOPS)
