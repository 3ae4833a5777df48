"""Back-compat shim: the native-protocol endpoint moved to
`cassandra_tpu_torch/transport/`.

  transport/frame.py      the v4/v5 wire codec (envelopes, v5 CRC
                          segment framing, body primitives, result
                          encoding) — byte-compatible with the codec
                          that lived here.
  transport/server.py     the selector-based event-loop CQLServer that
                          replaced the thread-per-connection server.
  transport/admission.py  permit gate, overload signals, per-client
                          rate limiting.

Everything importable from this module before the move still is; new
code should import from `cassandra_tpu_torch.transport` directly.
"""
from .transport.frame import (  # noqa: F401
    ERR_BAD_CREDENTIALS, ERR_INVALID, ERR_OVERLOADED, ERR_PROTOCOL,
    ERR_SERVER, ERR_UNPREPARED, EVENT_TYPES, MAX_SEGMENT_PAYLOAD,
    OP_AUTH_RESPONSE, OP_AUTH_SUCCESS, OP_AUTHENTICATE, OP_ERROR,
    OP_EVENT, OP_EXECUTE, OP_OPTIONS, OP_PREPARE, OP_QUERY, OP_READY,
    OP_REGISTER, OP_RESULT, OP_STARTUP, OP_SUPPORTED, RESULT_PREPARED,
    RESULT_ROWS, RESULT_SCHEMA_CHANGE, RESULT_SET_KEYSPACE, RESULT_VOID,
    SUPPORTED_VERSIONS, VERSION_REQ, VERSION_RSP, WireValue, _bytes,
    _crc24, _crc32_v5, _encode_rows, _inet, _infer_type, _long_string,
    _read_bytes, _read_long_string, _read_string, _read_string_map,
    _string, decode_segment_header, encode_envelope, encode_segment,
    error_body, frame_envelope, unprepared_body)
from .transport.server import CQLServer, Connection, _cert_identity  # noqa: F401

# the old per-connection state class was called _Conn
_Conn = Connection
