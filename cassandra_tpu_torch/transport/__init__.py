"""Client-facing native-protocol layer (transport/ in the reference).

`frame` is the v4/v5 wire codec (envelopes, v5 CRC segment framing,
body primitives, result encoding); the executor binds its wire values
(`WireValue`). The selector-based CQL server and its admission gate
are not in this package yet.
"""
