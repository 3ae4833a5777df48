"""Admin protocol: remote nodetool transport.

Reference counterpart: the JMX endpoint (port 7199) that
tools/nodetool/NodeProbe.java drives. Here: newline-delimited JSON over
TCP — request {"cmd": name, "args": {...}}, response {"ok": true,
"result": ...} | {"ok": false, "error": "..."}. Every command in
tools/nodetool.py's COMMANDS registry is remotely invokable, so a real
deployment is operated without shelling into the daemon process.

SECURITY: loopback binds run in the JMX-local trust model (shell access
to the box implies admin rights). Binding a NON-loopback address
REQUIRES a shared `secret`: the server refuses to start wide-open
(reference: JMX remote requires authentication by default,
jmx.remote.x.password.file), and every request must then carry
{"auth": secret}, compared constant-time. Transport encryption is the
operator's network layer (or front the port with the mTLS internode
listener); the secret gates command execution.
"""
from __future__ import annotations

import hmac
import json
import socket
import threading


def _is_loopback(host: str) -> bool:
    try:
        import ipaddress
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return host in ("localhost",)


class AdminServer:
    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None):
        if not _is_loopback(host) and not secret:
            raise ValueError(
                f"refusing to bind admin endpoint on non-loopback "
                f"{host!r} without a shared secret (set admin_secret); "
                f"unauthenticated remote admin is full remote control "
                f"of the node")
        self.secret = secret
        self.node = node
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(16)
        self.port = self._listen.getsockname()[1]
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"admin-{self.port}").start()

    def close(self) -> None:
        self._closed = True
        try:
            self._listen.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        import time
        while not self._closed:
            try:
                sock, addr = self._listen.accept()
            except OSError:
                if self._closed:
                    return
                # transient (EMFILE under a connection burst): keep the
                # admin endpoint alive, retry after a beat
                time.sleep(0.1)
                continue
            try:
                threading.Thread(target=self._serve, args=(sock, addr),
                                 daemon=True).start()
            except Exception:
                # thread exhaustion: shed this client, keep the admin
                # endpoint (nodetool) alive (ctpulint worker-loops)
                try:
                    sock.close()
                except OSError:
                    pass

    def _serve(self, sock: socket.socket, addr) -> None:
        from ..tools import nodetool
        try:
            f = sock.makefile("rwb")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    if self.secret is not None and not \
                            hmac.compare_digest(
                                str(req.get("auth") or ""), self.secret):
                        f.write(b'{"ok": false, "error": '
                                b'"AuthenticationError: bad or missing '
                                b'admin secret"}\n')
                        f.flush()
                        continue
                    result = nodetool.run_command(
                        req["cmd"], node=self.node,
                        **(req.get("args") or {}))
                    rsp = {"ok": True, "result": result}
                except Exception as e:
                    rsp = {"ok": False,
                           "error": f"{type(e).__name__}: {e}"}
                f.write(json.dumps(rsp, default=str).encode() + b"\n")
                f.flush()
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass


def admin_call(host: str, port: int, cmd: str, args: dict | None = None,
               timeout: float = 30.0, secret: str | None = None):
    """One-shot client call (nodetool --host/--port mode)."""
    req = {"cmd": cmd, "args": args or {}}
    if secret is not None:
        req["auth"] = secret
    with socket.create_connection((host, port), timeout=timeout) as sock:
        f = sock.makefile("rwb")
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        line = f.readline()
        if not line:
            raise ConnectionError("admin server closed the connection")
        rsp = json.loads(line)
    if not rsp.get("ok"):
        raise RuntimeError(rsp.get("error", "admin call failed"))
    return rsp.get("result")
