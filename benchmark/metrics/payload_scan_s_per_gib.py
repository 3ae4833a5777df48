"""Seconds the host spends scanning payload blocks for the LZ4 policy
(numpy, beside K5's scans of META and lanes) per GiB of input Data.db:
the task profile's `device_pack.payload_scan` span."""


def read(ctx):
    s = ctx["profile"].get("device_pack.payload_scan")
    return None if s is None else s / (ctx["input_bytes"] / 2**30)
