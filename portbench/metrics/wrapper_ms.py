"""wrapper_ms (ms, fused wrapper: `fused_step.steady_round` /
`damped_round`, the operand gathers and result scatters around the
kernel, and the dispatcher's predicate): device milliseconds of one fused
block outside the fused kernel, averaged over the traced fused blocks."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    rows = [ops for b, ops in zip(ctx.traced, ctx.trace.blocks) if b.fused]
    if not rows:
        return None
    outside = sum(o.dur for ops in rows for o in ops if ctx.fused_kernel not in o.name)
    return outside / 1e3 / len(rows)
