"""general_launches (launches/round, general step): device operations
(kernels, copies and sets) a general round, from the profiler's records in
the traced general blocks."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    rows = [(b, ops) for b, ops in zip(ctx.traced, ctx.trace.blocks) if not b.fused]
    if not rows:
        return None
    return sum(len(ops) for _, ops in rows) / sum(b.rounds for b, _ in rows)
