"""Set-up: process start to the first timed call (loading, building, the
warm-up frames or the session and its first final BA)."""


def read(ctx):
    return ctx["setup_s"]
