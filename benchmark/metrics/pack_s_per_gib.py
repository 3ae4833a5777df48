"""Seconds of the resident round's host side (packing the round's
operands and launching K1-K3) per GiB of input Data.db: the task
profile's `pack` span."""


def read(ctx):
    s = ctx["profile"].get("pack")
    return None if s is None else s / (ctx["input_bytes"] / 2**30)
