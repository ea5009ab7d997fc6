"""The Harris + NMS kernel's share of its roofline over the traced frames.

The least time the card needs for one call is its bytes at the H100's
published HBM bandwidth: the float32 image stack [C,H,W] read once and the
response and NMS maps written once, 12 C H W bytes (its 44 operations
per pixel at 67 TFLOP/s take less); the share is that time over the
kernel's device time in the trace."""

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, HBM3


def harris_bytes(C, H, W):
    return 12 * C * H * W


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    calls = [(c, t) for name, (c, t) in tr["ops"].items() if "harris" in name.lower()]
    if not calls:
        return None
    n, secs = sum(c for c, _ in calls), sum(t for _, t in calls)
    cams = ctx["rig"]["cameras"]
    W, H = cams[0]["size"]
    return 100.0 * n * harris_bytes(len(cams), H, W) / PEAK_BYTES_PER_S / secs
