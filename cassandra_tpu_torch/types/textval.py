"""Text -> typed python value for a column's CQL type.

The ONE conversion used everywhere a value arrives as a string with a
known column type: cqlsh COPY FROM csv cells (tools/copyutil.py),
nodetool getendpoints keys, and JSON map KEYS (JSON object keys are
always strings; cql3 Json.java parses them by the map's key type).
Reference counterpart: pylib/cqlshlib/copyutil.py converters (scalars).
"""
from __future__ import annotations

import datetime
import uuid


def parse_text_value(text: str, cql_type):
    if text == "":
        return None
    name = type(cql_type).__name__
    if name in ("Int32Type", "LongType", "SmallIntType", "TinyIntType",
                "IntegerType", "CounterColumnType"):
        return int(text)
    if name in ("FloatType", "DoubleType", "DecimalType"):
        return float(text)
    if name == "BooleanType":
        return text.strip().lower() in ("true", "1", "yes")
    if name in ("UUIDType", "TimeUUIDType"):
        return uuid.UUID(text)
    if name == "BlobType":
        return bytes.fromhex(text[2:] if text.startswith("0x") else text)
    if name == "TimestampType":
        try:
            return datetime.datetime.fromisoformat(text)
        except ValueError:
            return datetime.datetime.fromtimestamp(
                float(text) / 1000.0, tz=datetime.timezone.utc)
    return text      # text/ascii/inet and unknowns pass through
