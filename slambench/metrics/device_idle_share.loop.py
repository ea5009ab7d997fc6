"""Share of the traced frames' wall time in which no operation ran on the
device: 100 * (1 - the union of device-operation intervals / the traced
window)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
