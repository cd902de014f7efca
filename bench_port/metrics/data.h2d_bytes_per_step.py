"""Bytes copied from the host to the card a train step, from the trace's
copies (the cached path should copy only its step table and the epoch's
order)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["h2d_bytes"] is None:
        return None
    return t["h2d_bytes"] / ctx["steps"]
