"""idle_pct (%, device: the H100): the share of the traced sub-window, from
the first traced block's call to the last one's synchronisation, in which
no device operation runs."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
