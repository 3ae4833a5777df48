"""Seconds the compaction's merge thread waits on decoding its input
segments, per GiB of input Data.db: the task profile's `io_decode`
span."""


def read(ctx):
    s = ctx["profile"].get("io_decode")
    return None if s is None else s / (ctx["input_bytes"] / 2**30)
