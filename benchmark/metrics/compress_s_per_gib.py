"""Seconds of LZ4 compression in the host compressor pool, summed over
its threads, per GiB of input Data.db: the task profile's `compress`
span."""


def read(ctx):
    s = ctx["profile"].get("compress")
    return None if s is None else s / (ctx["input_bytes"] / 2**30)
