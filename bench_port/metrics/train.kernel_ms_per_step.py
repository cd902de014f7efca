"""Milliseconds a train step in which an operation ran on the card."""


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    return 1e3 * t["busy_s"] / ctx["steps"]
