"""Bytes copied between host and card, both ways, at the program's
transfer points, per MiB of input Data.db (the program's transfer
counters)."""


def read(ctx):
    t = ctx["transfers"]
    moved = t["h2d"]["bytes"] + t["d2h"]["bytes"]
    return None if moved == 0 else moved / (ctx["input_bytes"] / 2**20)
