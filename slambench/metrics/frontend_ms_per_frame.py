"""The frontend's tracking program ("1 frontend (fused)" of
``utils/timing.py``) over the window, per frame."""


def read(ctx):
    if "1 frontend (fused)" not in ctx["timing"]:
        return None
    return ctx["timing"]["1 frontend (fused)"][0] * 1e3 / len(ctx["frame_s"])
