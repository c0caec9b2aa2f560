"""The RcLLM engine's recompute set: tokens recomputed through layers
1..L-1 over prompt tokens, in %, from the engine's `EngineStats` of the
window's prefills (its recompute mask, read when the first token came)."""


def read(run):
    rs = [r for r in run.window_reqs() if r.recompute is not None]
    if not rs:
        return None
    return 100.0 * sum(int(r.recompute.sum()) for r in rs) / sum(r.n for r in rs)
