"""Device kernels per frame over the traced frames."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return tr["kernels"] / ctx["traced_frames"]
