"""The window solve ("3.2 solve" of ``utils/timing.py``) over the window,
per frame."""


def read(ctx):
    if "3.2 solve" not in ctx["timing"]:
        return None
    return ctx["timing"]["3.2 solve"][0] * 1e3 / len(ctx["frame_s"])
