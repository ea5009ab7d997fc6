"""Whole frames completed over the whole window (the time inside the port's
calls, frame generation left out)."""


def read(ctx):
    if not ctx["frame_s"]:
        return None
    return len(ctx["frame_s"]) / ctx["inside_s"]
