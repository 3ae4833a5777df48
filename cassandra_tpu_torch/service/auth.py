"""Authentication & authorization.

Reference counterpart: auth/ — PasswordAuthenticator (salted hashes in
system_auth.roles), CassandraAuthorizer (permissions in system_auth
tables), role management, and the round-3 depth set:

  AuthCache (auth/AuthCache.java:63): PBKDF2 verification and permission
    verdicts memoized with a validity window, invalidated on any
    role/grant mutation.
  CIDR authorization (auth/CIDRPermissionsManager.java): named CIDR
    groups; non-superuser roles restricted to groups are refused login
    from addresses outside them.
  Network authorization (auth/CassandraNetworkAuthorizer.java): roles
    with ACCESS TO DATACENTERS may only connect through coordinators in
    those DCs.
  Mutual-TLS identities (auth/MutualTlsAuthenticator.java): certificate
    identities (SPIFFE/CN role of identity_to_role) mapped to roles; a
    verified client cert authenticates without a password exchange.

Permissions model (subset): ALL / SELECT / MODIFY / CREATE / DROP /
AUTHORIZE on keyspaces ('ks' or 'ALL KEYSPACES').
"""
from __future__ import annotations

import hashlib
import ipaddress
import json
import os
import secrets
import threading
import time


class AuthenticationError(Exception):
    pass


class UnauthorizedError(Exception):
    pass


def _hash(password: str, salt: bytes) -> str:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                               100_000).hex()


class AuthCache:
    """TTL verdict cache (auth/AuthCache.java:63). Entries expire after
    `validity` seconds; any role/grant mutation invalidates everything
    (the reference's active-update invalidation, simplified)."""

    def __init__(self, validity: float = 2.0):
        self.validity = validity
        self._entries: dict = {}
        self._lock = threading.Lock()
        # bumped by invalidate_all(): a verdict computed under an older
        # generation must NOT be inserted after the flush — without this
        # an in-flight get() could re-cache a stale verdict (e.g. a
        # password verified just before the role's hash changed) for a
        # full validity window after the invalidation
        self._gen = 0

    def get(self, key, loader):
        now = time.monotonic()
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and now - hit[0] < self.validity:
                return hit[1]
            gen = self._gen
        value = loader()
        with self._lock:
            if self._gen == gen:
                self._entries[key] = (now, value)
                if len(self._entries) > 10_000:
                    self._entries.clear()  # crude bound; verdicts re-load
        return value

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()
            self._gen += 1


class AuthService:
    def __init__(self, directory: str, enabled: bool = False,
                 cache_validity: float = 2.0):
        self.path = os.path.join(directory, "system_auth.json")
        self.enabled = enabled
        self._lock = threading.Lock()
        self.roles: dict[str, dict] = {}
        # named CIDR groups: {"office": ["10.1.0.0/16", ...]}
        self.cidr_groups: dict[str, list[str]] = {}
        # mTLS certificate identity -> role (identity_to_role table)
        self.identities: dict[str, str] = {}
        self.cache = AuthCache(cache_validity)
        self._load()
        if enabled and "cassandra" not in self.roles:
            # default superuser (reference ships cassandra/cassandra);
            # disabled engines create nothing (no PBKDF2 cost, no file)
            self.create_role("cassandra", "cassandra", superuser=True)

    def _load(self):
        if os.path.exists(self.path):
            with open(self.path) as f:
                data = json.load(f)
            if "roles" in data:
                self.roles = data["roles"]
                self.cidr_groups = data.get("cidr_groups", {})
                self.identities = data.get("identities", {})
            else:   # pre-round-3 file: bare role map
                self.roles = data

    def _save(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"roles": self.roles,
                       "cidr_groups": self.cidr_groups,
                       "identities": self.identities}, f)
        os.replace(tmp, self.path)
        self.cache.invalidate_all()

    # ------------------------------------------------------------- roles --

    def create_role(self, name: str, password: str | None = None,
                    superuser: bool = False, login: bool = True):
        with self._lock:
            if name in self.roles:
                raise ValueError(f"role {name} exists")
            salt = secrets.token_bytes(16)
            self.roles[name] = {
                "salt": salt.hex(),
                "hash": _hash(password or "", salt),
                "superuser": superuser,
                "login": login,
                "grants": {},   # resource -> [permissions]
            }
            self._save()

    def alter_role(self, name: str, password: str | None = None,
                   superuser: bool | None = None):
        with self._lock:
            r = self.roles.get(name)
            if r is None:
                raise ValueError(f"unknown role {name}")
            if password is not None:
                salt = secrets.token_bytes(16)
                r["salt"] = salt.hex()
                r["hash"] = _hash(password, salt)
            if superuser is not None:
                r["superuser"] = bool(superuser)
            self._save()

    def drop_role(self, name: str, if_exists: bool = False):
        with self._lock:
            if name not in self.roles and not if_exists:
                raise ValueError(f"unknown role {name}")
            self.roles.pop(name, None)
            self._save()

    def authenticate(self, user: str, password: str) -> str:
        r = self.roles.get(user)
        if r is None or not r.get("login"):
            raise AuthenticationError(f"unknown role {user}")
        # the PBKDF2 pass is the expensive part — cache the verdict for
        # the validity window, keyed by a DIGEST of the credential (the
        # cleartext password must never be retained in process memory)
        ck = hashlib.sha256(f"{user}\x00{password}".encode()).hexdigest()
        ok = self.cache.get(
            ("cred", ck),
            lambda: _hash(password, bytes.fromhex(r["salt"])) == r["hash"])
        if not ok:
            raise AuthenticationError("bad credentials")
        return user

    # ------------------------------------------------- mTLS identities --

    def add_identity(self, identity: str, role: str) -> None:
        """ADD IDENTITY '<cert identity>' TO ROLE r (identity_to_role)."""
        with self._lock:
            if role not in self.roles:
                raise ValueError(f"unknown role {role}")
            self.identities[identity] = role
            self._save()

    def drop_identity(self, identity: str) -> None:
        with self._lock:
            self.identities.pop(identity, None)
            self._save()

    def authenticate_identity(self, identity: str) -> str:
        """Map a VERIFIED client-certificate identity to its role
        (MutualTlsAuthenticator.java: the TLS layer already proved key
        possession; this is only the identity->role lookup)."""
        role = self.identities.get(identity)
        if role is None or role not in self.roles:
            raise AuthenticationError(
                f"no role for certificate identity {identity!r}")
        if not self.roles[role].get("login"):
            raise AuthenticationError(f"role {role} cannot login")
        return role

    # -------------------------------------------- CIDR / network authz --

    def set_cidr_group(self, name: str, cidrs: list[str]) -> None:
        for c in cidrs:
            ipaddress.ip_network(c)   # validate loudly at define time
        with self._lock:
            self.cidr_groups[name] = list(cidrs)
            self._save()

    def drop_cidr_group(self, name: str) -> None:
        with self._lock:
            self.cidr_groups.pop(name, None)
            self._save()

    def alter_role_access(self, role: str,
                          cidr_groups: list[str] | None = None,
                          datacenters: list[str] | None = None) -> None:
        """ACCESS FROM CIDRS {...} / ACCESS TO DATACENTERS {...}.
        Passing a list restricts the role to it; None leaves that axis
        unchanged; an empty list clears the restriction."""
        with self._lock:
            r = self.roles.get(role)
            if r is None:
                raise ValueError(f"unknown role {role}")
            if cidr_groups is not None:
                unknown = [g for g in cidr_groups
                           if g not in self.cidr_groups]
                if unknown:
                    raise ValueError(f"unknown CIDR groups {unknown}")
                r["cidr_groups"] = list(cidr_groups)
            if datacenters is not None:
                r["datacenters"] = list(datacenters)
            self._save()

    def check_cidr(self, user: str, ip: str) -> None:
        """Refuse login from outside the role's CIDR groups
        (CIDRPermissionsManager semantics: superusers and unrestricted
        roles connect from anywhere)."""
        if not self.enabled:
            return
        r = self.roles.get(user)
        if r is None or r.get("superuser"):
            return
        groups = r.get("cidr_groups")
        if not groups:
            return

        def verdict():
            addr = ipaddress.ip_address(ip)
            for g in groups:
                for c in self.cidr_groups.get(g, []):
                    if addr in ipaddress.ip_network(c):
                        return True
            return False

        if not self.cache.get(("cidr", user, ip), verdict):
            raise UnauthorizedError(
                f"{user} may not connect from {ip} "
                f"(restricted to CIDR groups {groups})")

    def check_datacenter(self, user: str, dc: str) -> None:
        """Network authorization: the role must be allowed in the
        coordinator's datacenter (CassandraNetworkAuthorizer)."""
        if not self.enabled:
            return
        r = self.roles.get(user)
        if r is None or r.get("superuser"):
            return
        dcs = r.get("datacenters")
        if not dcs:   # unrestricted (ACCESS TO ALL DATACENTERS)
            return
        if dc not in dcs:
            raise UnauthorizedError(
                f"{user} has no access to datacenter {dc} "
                f"(allowed: {sorted(dcs)})")

    # -------------------------------------------------------------- authz --

    def grant(self, permission: str, resource: str, role: str):
        with self._lock:
            r = self.roles.get(role)
            if r is None:
                raise ValueError(f"unknown role {role}")
            r["grants"].setdefault(resource.lower(), [])
            perms = r["grants"][resource.lower()]
            if permission.upper() not in perms:
                perms.append(permission.upper())
            self._save()

    def revoke(self, permission: str, resource: str, role: str):
        with self._lock:
            r = self.roles.get(role)
            if r is not None:
                perms = r["grants"].get(resource.lower(), [])
                if permission.upper() in perms:
                    perms.remove(permission.upper())
                self._save()

    def require_superuser(self, user: str | None) -> None:
        """Role/permission management is superuser-only (prevents
        privilege escalation via keyspace-scoped AUTHORIZE)."""
        if not self.enabled:
            return
        r = self.roles.get(user or "")
        if r is None or not r.get("superuser"):
            raise UnauthorizedError(
                f"{user or 'anonymous'} must be a superuser")

    def check(self, user: str | None, permission: str,
              keyspace: str | None) -> None:
        if not self.enabled:
            return
        if user is None:
            raise UnauthorizedError("not authenticated")

        def verdict() -> bool:
            r = self.roles.get(user)
            if r is None:
                return False
            if r.get("superuser"):
                return True
            for resource in (keyspace or "", "all keyspaces"):
                perms = r["grants"].get(resource.lower(), [])
                if "ALL" in perms or permission.upper() in perms:
                    return True
            return False

        if not self.cache.get(("perm", user, permission, keyspace),
                              verdict):
            raise UnauthorizedError(
                f"{user} has no {permission} on {keyspace or 'cluster'}")
