"""Byte-comparable encodings: map typed values to byte strings whose
unsigned lexicographic order equals the type's comparison order.

This is the substrate that lets the device merge kernel compare clustering
keys as fixed-width integer lanes (reference semantics:
src/java/org/apache/cassandra/utils/bytecomparable/ByteComparable.md and
ByteSourceInverse.java; our encodings are our own design, not the OSS41
format — we never need to interoperate with reference files).

Composite encoding: each component is escaped so that 0x00 never appears
raw (0x00 -> 0x00 0x01), then terminated with 0x00 0x00. A shorter
composite that is a prefix of a longer one therefore sorts first, and
component boundaries cannot bleed into each other. For DESC (reversed)
clustering columns the escaped component bytes are complemented and the
escape/terminator pair flips to 0xFF-based, preserving order reversal.
"""
from __future__ import annotations

import struct

SEP = b"\x00\x00"           # ascending terminator
SEP_DESC = b"\xff\xff"      # descending terminator

# ---------------------------------------------------------------- scalars --


def encode_int(v: int, width: int) -> bytes:
    """Signed big-endian with flipped sign bit: orders as signed compare."""
    bias = 1 << (width * 8 - 1)
    return (v + bias).to_bytes(width, "big")


def decode_int(b: bytes, width: int) -> int:
    bias = 1 << (width * 8 - 1)
    return int.from_bytes(b, "big") - bias


def encode_float(v: float, double: bool = True) -> bytes:
    """IEEE754 with the standard order-preserving transform:
    positive: flip sign bit; negative: flip all bits. NaNs sort last."""
    raw = struct.pack(">d", v) if double else struct.pack(">f", v)
    n = int.from_bytes(raw, "big")
    bits = 64 if double else 32
    if n >> (bits - 1):  # negative
        n = (~n) & ((1 << bits) - 1)
    else:
        n |= 1 << (bits - 1)
    return n.to_bytes(bits // 8, "big")


def decode_float(b: bytes, double: bool = True) -> float:
    bits = 64 if double else 32
    n = int.from_bytes(b, "big")
    if n >> (bits - 1):
        n &= (1 << (bits - 1)) - 1
    else:
        n = (~n) & ((1 << bits) - 1)
    raw = n.to_bytes(bits // 8, "big")
    return struct.unpack(">d" if double else ">f", raw)[0]


def encode_varint(v: int) -> bytes:
    """Arbitrary-precision integer, order-preserving.

    Layout: 1 length-class byte then magnitude. Positive: 0x80+len then BE
    magnitude; negative: 0x7F-len then complemented BE magnitude; zero: 0x80.
    Correct for |magnitude| < 2^(8*127)."""
    if v == 0:
        return b"\x80"
    if v > 0:
        mag = v.to_bytes((v.bit_length() + 7) // 8, "big")
        if len(mag) > 0x7F:
            raise ValueError("varint too large")
        return bytes([0x80 + len(mag)]) + mag
    m = -v
    mag = m.to_bytes((m.bit_length() + 7) // 8, "big")
    if len(mag) > 0x7E:
        raise ValueError("varint too large")
    comp = bytes(0xFF - b for b in mag)
    return bytes([0x7F - len(mag)]) + comp


def decode_varint(b: bytes) -> int:
    cls = b[0]
    if cls == 0x80:
        return 0
    if cls > 0x80:
        return int.from_bytes(b[1:1 + (cls - 0x80)], "big")
    n = 0x7F - cls
    mag = bytes(0xFF - x for x in b[1:1 + n])
    return -int.from_bytes(mag, "big")


# -------------------------------------------------------------- composite --


def escape_component(data: bytes, desc: bool = False) -> bytes:
    """Escape a component so the terminator can't be confused with data."""
    if not desc:
        return data.replace(b"\x00", b"\x00\x01")
    inv = bytes(0xFF - b for b in data)
    return inv.replace(b"\xff", b"\xff\xfe")


def unescape_component(data: bytes, desc: bool = False) -> bytes:
    if not desc:
        return data.replace(b"\x00\x01", b"\x00")
    raw = data.replace(b"\xff\xfe", b"\xff")
    return bytes(0xFF - b for b in raw)


def encode_composite(components: list[bytes], descending: list[bool] | None = None) -> bytes:
    """Concatenate escaped components with terminators. The result's
    lexicographic order equals tuple-wise order of the components (with
    per-component ASC/DESC)."""
    out = bytearray()
    for i, c in enumerate(components):
        desc = bool(descending[i]) if descending else False
        out += escape_component(c, desc)
        out += SEP_DESC if desc else SEP
    return bytes(out)


def decode_composite(data: bytes, n: int, descending: list[bool] | None = None) -> list[bytes]:
    """Split a composite back into n raw components."""
    comps = []
    pos = 0
    for i in range(n):
        desc = bool(descending[i]) if descending else False
        term = SEP_DESC if desc else SEP
        esc = b"\xff\xfe" if desc else b"\x00\x01"
        # scan for terminator not part of an escape
        j = pos
        while True:
            j = data.index(term[0:1], j)
            if data[j: j + 2] == esc:
                j += 2
                continue
            if data[j: j + 2] == term:
                break
            j += 1
        comps.append(unescape_component(data[pos:j], desc))
        pos = j + 2
    return comps
