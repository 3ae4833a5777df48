"""TLS for the internode and native-protocol transports.

Reference counterpart: security/SSLFactory.java driven by
conf/cassandra.yaml `server_encryption_options` (internode, mutual TLS
against the cluster CA) and `client_encryption_options` (native
protocol: server cert, optionally required client certs). Contexts are
built once per transport; python's ssl module does the wire work.

Internode peers dial each other by address, so hostname checking is
off and trust roots at the CLUSTER CA instead — only certificates the
operator signed can join, which is the property internode TLS exists
to enforce (encryption + peer authentication, not DNS identity).
"""
from __future__ import annotations

import ssl
from dataclasses import dataclass


@dataclass
class TLSConfig:
    certfile: str
    keyfile: str
    cafile: str | None = None
    require_client_auth: bool = True   # mutual TLS (internode default)

    def __post_init__(self):
        if self.require_client_auth and not self.cafile:
            # refusing to build a half-configured trust story: without
            # a CA, "require client auth" would silently verify nothing
            # and any TLS speaker could join the cluster
            raise ValueError(
                "require_client_auth needs cafile (the cluster CA); "
                "pass require_client_auth=False for encryption-only")

    @classmethod
    def from_dict(cls, d: dict | None) -> "TLSConfig | None":
        if not d:
            return None
        return cls(d["certfile"], d["keyfile"], d.get("cafile"),
                   bool(d.get("require_client_auth", True)))

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        if self.require_client_auth:
            ctx.load_verify_locations(self.cafile)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self) -> ssl.SSLContext:
        return client_side_context(self.cafile, self.certfile,
                                   self.keyfile)


def client_side_context(cafile: str | None = None,
                        certfile: str | None = None,
                        keyfile: str | None = None) -> ssl.SSLContext:
    """The ONE outbound-TLS context builder — internode dialers and the
    native-protocol driver both come through here, so hardening (min
    version, ciphers) lands in both. Verifies the server against
    `cafile` (trust-all when omitted — lab default for the driver;
    internode configs always carry a CA via TLSConfig validation) and
    presents a client cert only if given."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    if cafile:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cafile)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if certfile:
        ctx.load_cert_chain(certfile, keyfile)
    return ctx
