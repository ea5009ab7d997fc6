"""LM iterations per window solve over the window, as the solves' own
answers count them: how much of the window solve's work a change to the
stopping rule or the realtime budget adds or takes away."""


def read(ctx):
    iters = ctx.get("lm_iterations") or []
    if not iters:
        return None
    return sum(iters) / len(iters)
