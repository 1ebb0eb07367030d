"""Auth: password hashing and HS256 JWTs on the standard library.

The port's copy of ``rafiki_tpu/utils/auth.py``: the admin REST
service's tokens are RFC 7519 HS256 JWTs built on ``hmac``, ``hashlib``
and ``base64``, and passwords are PBKDF2-SHA256 with a random salt. The
formats are the reference's, so a token or a password hash made by
either package verifies in the other.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Any, Dict, Optional

_ALG_HEADER = {"alg": "HS256", "typ": "JWT"}


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def encode_token(payload: Dict[str, Any], secret: str,
                 expires_in: float = 24 * 3600) -> str:
    body = dict(payload)
    body["exp"] = time.time() + expires_in
    h = _b64url(json.dumps(_ALG_HEADER, separators=(",", ":")).encode())
    p = _b64url(json.dumps(body, separators=(",", ":")).encode())
    sig = hmac.new(secret.encode(), f"{h}.{p}".encode(),
                   hashlib.sha256).digest()
    return f"{h}.{p}.{_b64url(sig)}"


def decode_token(token: str, secret: str) -> Dict[str, Any]:
    """Verify signature + expiry; raises ``ValueError`` on any failure."""
    try:
        h, p, s = token.split(".")
    except ValueError:
        raise ValueError("malformed token")
    expected = hmac.new(secret.encode(), f"{h}.{p}".encode(),
                        hashlib.sha256).digest()
    if not hmac.compare_digest(expected, _unb64url(s)):
        raise ValueError("bad signature")
    payload = json.loads(_unb64url(p))
    if payload.get("exp", 0) < time.time():
        raise ValueError("token expired")
    return payload


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    salt = salt if salt is not None else os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 100_000)
    return f"{salt.hex()}${digest.hex()}"


def verify_password(password: str, hashed: str) -> bool:
    try:
        salt_hex, digest_hex = hashed.split("$")
    except ValueError:
        return False
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), 100_000)
    return hmac.compare_digest(digest.hex(), digest_hex)
