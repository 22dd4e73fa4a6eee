"""fused_pct (%, dispatch layer: `fused_step.steady_predicate`'s
whole-batch branch): the share of the window's group-rounds that ran on
the fused kernel, from the dispatcher's own count (`count_fused`)."""


def read(ctx):
    if not ctx.group_rounds:
        return None
    return 100.0 * ctx.fused_group_rounds / ctx.group_rounds
