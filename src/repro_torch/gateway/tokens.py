"""Signed wire-level resumption tokens for durable gateway sessions.

Counterpart of ``repro/gateway/tokens.py``: the same secret file gives the
same token bytes in both packages, so a token minted by one resumes in
the other.

A token is the client's proof that it owns a durable stream: every
``step`` response carries a fresh one, and presenting it to ANY worker
(via the ``resume`` op) restores the session from the latest snapshot.
Tokens are bearer credentials — compact, stateless, verifiable by every
worker sharing the store's secret file — so resumption needs no session
registry and survives the issuing worker being SIGKILLed.

Format (three dot-separated fields, URL-safe)::

    rt1.<base64url(payload-json)>.<base64url(hmac-sha256(secret, "rt1." + payload))>

Payload fields: ``sid`` (durable session id), ``seq`` (timesteps the
session had observed when the token was minted), ``epoch`` (recalibration
epoch at mint time), ``iat``/``exp`` (issue / expiry, unix seconds;
``exp`` null when the signer has no TTL).

The secret is 32 random bytes persisted once per store directory
(``token.secret``, mode 0600) so every worker — including respawns —
verifies every other worker's tokens.  Stdlib only.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

TOKEN_VERSION = "rt1"
SECRET_FILENAME = "token.secret"
_SECRET_BYTES = 32


class TokenError(ValueError):
    """Base class for resumption-token rejections.  The class NAME is the
    wire-level error code (``error`` field of the refusal response)."""


class TamperedTokenError(TokenError):
    """Signature mismatch or unparseable structure — the token was not
    minted (as presented) by any worker holding this store's secret."""


class ExpiredTokenError(TokenError):
    """Authentic token past its ``exp`` timestamp."""


class UnknownSessionError(TokenError):
    """Authentic, unexpired token whose session exists in no reachable
    snapshot — closed, expired out of the store, or never durable."""


@dataclass(frozen=True)
class SessionClaim:
    """The verified contents of a resumption token."""

    sid: str
    seq: int
    epoch: int
    issued_at: float
    expires_at: Optional[float]


def _b64e(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode("ascii")


def _b64d(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


def load_or_create_secret(directory: str | Path) -> bytes:
    """The store's shared signing secret, created atomically on first use
    (``os.O_EXCL`` — concurrent worker boots race safely, one wins and the
    rest read the winner's bytes)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / SECRET_FILENAME
    if not path.exists():
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        except FileExistsError:
            pass
        else:
            with os.fdopen(fd, "wb") as fh:
                fh.write(os.urandom(_SECRET_BYTES))
    secret = path.read_bytes()
    if len(secret) < 16:
        raise TokenError(f"secret file {path} is too short to be trusted")
    return secret


class TokenSigner:
    """Mints and verifies resumption tokens with one shared secret.

    ``ttl_s=None`` disables expiry; ``clock`` is injectable for tests.
    Verification order matters: structure/signature first (tampered), then
    expiry — an attacker must not learn whether a forged token's payload
    was otherwise plausible.
    """

    def __init__(self, secret: bytes, *, ttl_s: Optional[float] = 3600.0,
                 clock: Callable[[], float] = time.time):
        if not secret:
            raise ValueError("empty token secret")
        self._secret = bytes(secret)
        self.ttl_s = ttl_s
        self._clock = clock

    def _sign(self, payload_b64: str) -> str:
        mac = hmac.new(
            self._secret,
            f"{TOKEN_VERSION}.{payload_b64}".encode("ascii"),
            hashlib.sha256,
        ).digest()
        return _b64e(mac)

    def issue(self, sid: str, seq: int, epoch: int = 0) -> str:
        now = self._clock()
        payload = {
            "sid": str(sid),
            "seq": int(seq),
            "epoch": int(epoch),
            "iat": round(now, 3),
            "exp": None if self.ttl_s is None else round(now + self.ttl_s, 3),
        }
        payload_b64 = _b64e(
            json.dumps(payload, separators=(",", ":")).encode("utf-8")
        )
        return f"{TOKEN_VERSION}.{payload_b64}.{self._sign(payload_b64)}"

    def verify(self, token: str) -> SessionClaim:
        """Returns the claim or raises :class:`TamperedTokenError` /
        :class:`ExpiredTokenError`."""
        if not isinstance(token, str):
            raise TamperedTokenError("token must be a string")
        parts = token.split(".")
        if len(parts) != 3 or parts[0] != TOKEN_VERSION:
            raise TamperedTokenError("malformed resumption token")
        _, payload_b64, sig = parts
        if not hmac.compare_digest(sig, self._sign(payload_b64)):
            raise TamperedTokenError("resumption token signature mismatch")
        try:
            payload = json.loads(_b64d(payload_b64).decode("utf-8"))
            claim = SessionClaim(
                sid=str(payload["sid"]),
                seq=int(payload["seq"]),
                epoch=int(payload.get("epoch", 0)),
                issued_at=float(payload.get("iat", 0.0)),
                expires_at=(None if payload.get("exp") is None
                            else float(payload["exp"])),
            )
        except (ValueError, KeyError, TypeError) as e:
            # signature verified but payload undecodable: a signer bug or a
            # version skew, still refuse as tampered (never half-trust)
            raise TamperedTokenError(f"undecodable token payload: {e}") from e
        if claim.expires_at is not None and self._clock() > claim.expires_at:
            raise ExpiredTokenError(
                f"resumption token for {claim.sid!r} expired "
                f"{self._clock() - claim.expires_at:.1f}s ago"
            )
        return claim
