"""Transparent data encryption (TDE) — at-rest encryption for sstables
and commitlog segments.

Reference counterpart: security/EncryptionContext.java:41 (key provider +
cipher for encrypted commitlog/hints/sstable options),
db/commitlog/EncryptedSegment.java.

Design: AES-256-CTR keystream XOR applied to the ON-DISK byte stream at
its file offset. CTR is seekable (counter = offset/16), so the O_DIRECT
chunked writer and the scatter-preadv reader encrypt/decrypt at arbitrary
offsets without re-streaming the file. Block CRCs and the file digest are
computed over the CIPHERTEXT: corruption checks and `sstableverify` work
without keys, and plaintext never hits the disk path.

Keys live in a keystore directory (`key_<id>.bin`, 32 random bytes); the
highest id is the CURRENT key for new files, old keys stay for reading —
rotation = `create_key()` + recompaction (new output re-encrypts with the
current key). Each encrypted file records its key id + random nonce
(sstables in an Encryption.db component; commitlog segments in a header).

The active context is node-level state (the reference hangs it off
DatabaseDescriptor): engines install it via set_context at startup.
"""
from __future__ import annotations

import os
import re
import threading

_KEY_RE = re.compile(r"^key_(\d+)\.bin$")

_context = None
_ctx_lock = threading.Lock()


def set_context(ctx: "EncryptionContext | None") -> None:
    global _context
    with _ctx_lock:
        _context = ctx


def get_context() -> "EncryptionContext | None":
    return _context


class EncryptionError(RuntimeError):
    pass


class EncryptionContext:
    def __init__(self, keystore_dir: str):
        self.keystore_dir = keystore_dir
        os.makedirs(keystore_dir, exist_ok=True)
        self._keys: dict[int, bytes] = {}
        self._load()
        if not self._keys:
            self.create_key()

    def _load(self) -> None:
        for fn in os.listdir(self.keystore_dir):
            m = _KEY_RE.match(fn)
            if m:
                with open(os.path.join(self.keystore_dir, fn), "rb") as f:
                    key = f.read()
                if len(key) != 32:
                    raise EncryptionError(f"bad key file {fn}")
                self._keys[int(m.group(1))] = key

    @property
    def current_key_id(self) -> int:
        return max(self._keys)

    def create_key(self) -> int:
        """Key rotation: new files encrypt under the new id; existing
        files stay readable under their recorded ids."""
        kid = max(self._keys, default=0) + 1
        path = os.path.join(self.keystore_dir, f"key_{kid}.bin")
        with open(path, "wb") as f:
            f.write(os.urandom(32))
            f.flush()
            os.fsync(f.fileno())
        self._load()
        return kid

    def new_nonce(self) -> bytes:
        return os.urandom(16)

    def xor_at(self, key_id: int, nonce16: bytes, offset: int,
               data) -> bytes:
        """data XOR keystream(key, nonce) positioned at byte `offset` of
        the stream — encryption and decryption are the same operation."""
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
        key = self._keys.get(key_id)
        if key is None:
            raise EncryptionError(
                f"key id {key_id} missing from keystore "
                f"{self.keystore_dir} (copy the key file from the "
                f"writing node)")
        block, skip = divmod(offset, 16)
        iv = ((int.from_bytes(nonce16, "big") + block)
              % (1 << 128)).to_bytes(16, "big")
        enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
        out = enc.update(bytes(skip) + bytes(data))
        return out[skip:]
