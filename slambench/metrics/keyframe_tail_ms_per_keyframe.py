"""The keyframe tail over the window per keyframe: keyframe extras, place
recognition, the CNN gate and loop closure (``utils/timing.py``)."""

STAGES = ("2.05 keyframe extras", "2.06 place recognition", "2.07 cnn suppression",
          "2.08 loop closure")


def read(ctx):
    if not ctx["keyframes"]:
        return None
    total = sum(ctx["timing"][s][0] for s in STAGES if s in ctx["timing"])
    return total * 1e3 / ctx["keyframes"]
