"""Variable-length integer encodings used by the on-disk formats.

Semantics mirror the reference's vint encoding
(reference: src/java/org/apache/cassandra/utils/vint/VIntCoding.java):
unsigned vints store the value in 1-9 bytes with the count of extra bytes
unary-encoded in the first byte's leading ones; signed vints zigzag first.
"""
from __future__ import annotations


def write_unsigned_vint(value: int, out: bytearray) -> None:
    if value < 0:
        raise ValueError("unsigned vint must be >= 0")
    if value < 0x80:
        out.append(value)
        return
    # minimal size: first byte holds (7 - extra) value bits
    extra = 0
    while extra < 8:
        if value < (1 << (8 * extra + (7 - extra))):
            break
        extra += 1
    if extra == 8:
        out.append(0xFF)
        out.extend(value.to_bytes(8, "big"))
        return
    first = (0xFF << (8 - extra)) & 0xFF
    first |= value >> (8 * extra)
    out.append(first)
    out.extend((value & ((1 << (8 * extra)) - 1)).to_bytes(extra, "big"))


def read_unsigned_vint(buf, pos: int) -> tuple[int, int]:
    first = buf[pos]
    if first < 0x80:
        return first, pos + 1
    # count leading ones
    extra = 0
    b = first
    while b & 0x80:
        extra += 1
        b = (b << 1) & 0xFF
    if extra == 8:
        return int.from_bytes(buf[pos + 1: pos + 9], "big"), pos + 9
    value = first & (0xFF >> extra)
    for i in range(extra):
        value = (value << 8) | buf[pos + 1 + i]
    return value, pos + 1 + extra


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def write_signed_vint(value: int, out: bytearray) -> None:
    write_unsigned_vint(zigzag(value) & 0xFFFFFFFFFFFFFFFF, out)


def read_signed_vint(buf, pos: int) -> tuple[int, int]:
    v, pos = read_unsigned_vint(buf, pos)
    return unzigzag(v), pos
