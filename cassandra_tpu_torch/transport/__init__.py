"""Client-facing native-protocol layer (transport/ in the reference).

`frame` is the v4/v5 wire codec (envelopes, v5 CRC segment framing,
body primitives, result encoding); the executor binds its wire values
(`WireValue`). `server` is the selector-based event-loop CQL server
(transport/Server.java + Dispatcher.java roles); `admission` is the
overload/permit/rate-limit gate in front of the request executor.
`cassandra_tpu_torch.transport_server` remains as a back-compat shim
re-exporting the public surface.
"""
from .server import CQLServer  # noqa: F401
