"""general_round_ms (ms, general step: `sim.step`, `sim._damped_linked_step`
under `fast_multi_round`'s general branch): host wall milliseconds a
general round, over the blocks the dispatcher ran general (those outside
the profiler's sub-window, where the window has any)."""


def read(ctx):
    general = [b for b in ctx.blocks if not b.fused]
    untraced = [b for b in general if not b.traced]
    rows = untraced or general
    if not rows:
        return None
    return 1e3 * sum(b.t_end - b.t_issue for b in rows) / sum(b.rounds for b in rows)
