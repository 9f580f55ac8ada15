"""Security: auth manager (device identity, PIN, sessions) + key
management, with encrypted state persistence.

Parity target: the reference's security stack — C auth manager with
device ID, PIN set/verify, sessions carrying permissions + expiry, and
state save/load (reference: src/security/tk_auth_manager.h:49-247), and
XChaCha20-Poly1305 state encryption via libsodium (tk_encryption.c:7-40)
— here ChaCha20-Poly1305 from the native C++ runtime
(trackiellm_tpu_torch.ffi.native), keys derived from the PIN with PBKDF2.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import secrets
import time
from typing import Dict, List, Optional

from trackiellm_tpu_torch.ffi.native import (
    aead_decrypt,
    aead_encrypt,
    constant_time_compare,
)
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import AuditTrail
from trackiellm_tpu_torch.utils.paths import Path

_PBKDF2_ITERS = 100_000


class KeyManager:
    """Key derivation + rotation (parity: key_management.rs)."""

    @staticmethod
    def derive_key(secret: str, salt: bytes) -> bytes:
        return hashlib.pbkdf2_hmac("sha256", secret.encode(), salt,
                                   _PBKDF2_ITERS, dklen=32)

    @staticmethod
    def new_salt() -> bytes:
        return secrets.token_bytes(16)

    @staticmethod
    def new_nonce() -> bytes:
        return secrets.token_bytes(12)


@dataclasses.dataclass
class Session:
    session_id: str
    permissions: List[str]
    created_at: float
    expires_at: float

    @property
    def expired(self) -> bool:
        return time.time() >= self.expires_at

    def allows(self, permission: str) -> bool:
        return not self.expired and (
            permission in self.permissions or "*" in self.permissions)


class AuthManager:
    """Device identity + PIN auth + session store."""

    def __init__(self, state_path: Optional[str] = None,
                 session_ttl_s: float = 3600.0):
        self._path = Path(state_path) if state_path else None
        self.session_ttl_s = session_ttl_s
        self.device_id = secrets.token_hex(8)
        self._pin_salt: Optional[bytes] = None
        self._pin_hash: Optional[bytes] = None
        self._sessions: Dict[str, Session] = {}
        self._audit = AuditTrail()

    # -- PIN ------------------------------------------------------------
    def set_pin(self, pin: str) -> None:
        if len(pin) < 4:
            raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                               "PIN must be at least 4 digits")
        self._pin_salt = KeyManager.new_salt()
        self._pin_hash = KeyManager.derive_key(pin, self._pin_salt)
        self._audit.auth_event(self.device_id, "pin_set", True)

    def verify_pin(self, pin: str) -> bool:
        if self._pin_hash is None or self._pin_salt is None:
            return False
        candidate = KeyManager.derive_key(pin, self._pin_salt)
        ok = constant_time_compare(candidate, self._pin_hash)
        self._audit.auth_event(self.device_id, "pin_verify", ok)
        return ok

    @property
    def has_pin(self) -> bool:
        return self._pin_hash is not None

    # -- sessions -----------------------------------------------------------
    def create_session(self, pin: str,
                       permissions: Optional[List[str]] = None,
                       ) -> Session:
        if not self.verify_pin(pin):
            raise TrackieError(ErrorCode.AUTH_FAILED, "wrong PIN")
        now = time.time()
        s = Session(secrets.token_hex(16), permissions or ["*"], now,
                    now + self.session_ttl_s)
        self._sessions[s.session_id] = s
        return s

    def check_permission(self, session_id: str, permission: str) -> bool:
        s = self._sessions.get(session_id)
        return bool(s and s.allows(permission))

    def revoke_session(self, session_id: str) -> bool:
        return self._sessions.pop(session_id, None) is not None

    def prune_expired(self) -> int:
        dead = [k for k, s in self._sessions.items() if s.expired]
        for k in dead:
            del self._sessions[k]
        return len(dead)

    # -- encrypted persistence (parity: state save/load h:235-247) --------
    def save_state(self, pin: str) -> None:
        if self._path is None:
            raise TrackieError(ErrorCode.INVALID_STATE, "no state path")
        if not self.verify_pin(pin):
            raise TrackieError(ErrorCode.AUTH_FAILED, "wrong PIN")
        payload = json.dumps({
            "device_id": self.device_id,
            "pin_salt": self._pin_salt.hex(),
            "pin_hash": self._pin_hash.hex(),
            "sessions": [dataclasses.asdict(s)
                         for s in self._sessions.values()],
        }).encode()
        salt = KeyManager.new_salt()
        nonce = KeyManager.new_nonce()
        key = KeyManager.derive_key(pin, salt)
        blob = salt + nonce + aead_encrypt(key, nonce, payload,
                                           aad=b"tk-auth-state-v1")
        self._path.write_bytes_atomic(blob)
        self._audit.record("auth", self.device_id, "state_saved")

    def load_state(self, pin: str) -> None:
        if self._path is None or not self._path.exists():
            raise TrackieError(ErrorCode.FILE_NOT_FOUND, str(self._path))
        blob = self._path.read_bytes()
        salt, nonce, ct = blob[:16], blob[16:28], blob[28:]
        key = KeyManager.derive_key(pin, salt)
        try:
            payload = aead_decrypt(key, nonce, ct, aad=b"tk-auth-state-v1")
        except ValueError as e:
            raise TrackieError(ErrorCode.AUTH_FAILED,
                               "state decryption failed (wrong PIN or "
                               "tampered file)") from e
        obj = json.loads(payload)
        self.device_id = obj["device_id"]
        self._pin_salt = bytes.fromhex(obj["pin_salt"])
        self._pin_hash = bytes.fromhex(obj["pin_hash"])
        self._sessions = {
            s["session_id"]: Session(**s) for s in obj["sessions"]
        }
        self._audit.record("auth", self.device_id, "state_loaded")
