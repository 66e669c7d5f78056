"""Auth middleware: basic, API-key, and OAuth (JWT/JWKS) providers (the
port's copy of ``gofr_tpu/http/auth.py``).

Mirrors reference pkg/gofr/http/middleware/{auth,basic_auth,
apikey_auth,oauth}.go and pkg/gofr/auth.go: a generic
``auth_middleware(provider)`` wraps the chain; providers authenticate
the request and attach auth info that surfaces as ``ctx.auth_info``
(reference context.go:121 GetAuthInfo). ``/.well-known`` paths are
exempt (reference middleware/validate.go:5-7).

OAuth validates ``Authorization: Bearer <jwt>`` tokens against a JWKS
key set, refreshed in the background (reference oauth.go:69-138); both
RS256 (via ``cryptography``) and HS256 are supported.

``cryptography`` is imported inside the RS256 calls only. Where it is
not installed, an RS256 token is refused with a typed 401 whose message
names the missing package (:class:`MissingDependency`), and an RSA JWK
is skipped with a warning; HS256, basic and API-key auth work as
everywhere.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import hashlib
import hmac
import json
import time
from typing import Any, Awaitable, Callable, Mapping, Protocol

from .request import HTTPRequest
from .responder import ResponseData
from .server import Handler, Middleware

EXEMPT_PREFIXES = ("/.well-known/",)


class AuthProvider(Protocol):
    """Returns auth info on success, None on failure."""

    def authenticate(self, request: HTTPRequest) -> Any: ...


def credential_fingerprint(secret: str) -> str:
    """Short stable hash standing in for a raw credential anywhere it
    could be logged, traced or used as a metric label. Long enough to
    correlate a tenant across restarts, far too short to recover or
    use as the key."""
    return hashlib.sha256(secret.encode()).hexdigest()[:12]


class TenantResolver:
    """Auth principal -> bounded-cardinality tenant label.

    The accounting identity for usage metering and per-tenant metrics:
    maps whatever an auth provider attached (``ctx.auth_info``) to one
    short string safe to use as a Prometheus label. Resolution order:

    - ``tenant`` key (set by ``APIKeyAuthProvider(key_names=...)``)
    - basic-auth ``username``
    - JWT claims: the first of ``claim_keys`` (default ``org`` then
      ``sub``)
    - hashed ``api_key`` (providers already store the fingerprint,
      never the raw key)
    - anything else hashes into a ``t-<fingerprint>`` bucket; an empty
      principal is ``anonymous``.

    Cardinality is HARD-bounded: after ``max_tenants`` distinct labels
    have been seen, new ones collapse to ``other`` — a credential
    stuffing run cannot blow up the label space. Labels are
    sanitized to ``[A-Za-z0-9_.:-]`` and capped at 64 chars.
    """

    OTHER = "other"
    ANONYMOUS = "anonymous"

    def __init__(self, max_tenants: int = 256,
                 claim_keys: tuple = ("org", "sub")) -> None:
        self.max_tenants = max(1, int(max_tenants))
        self.claim_keys = tuple(claim_keys)
        self._seen: set[str] = set()
        self._lock = __import__("threading").Lock()

    @staticmethod
    def _sanitize(label: str) -> str:
        clean = "".join(c if (c.isalnum() or c in "_.:-") else "_"
                        for c in str(label))
        return clean[:64] or TenantResolver.ANONYMOUS

    def label_for(self, info: Mapping[str, Any] | None) -> str:
        """Raw label before the cardinality bound."""
        if not info:
            return self.ANONYMOUS
        if info.get("tenant"):
            return self._sanitize(info["tenant"])
        if info.get("username"):
            return self._sanitize(info["username"])
        claims = info.get("claims")
        if isinstance(claims, Mapping):
            for key in self.claim_keys:
                if claims.get(key):
                    return self._sanitize(claims[key])
        if info.get("api_key"):
            # providers store the fingerprint; label it recognizably
            return self._sanitize(f"key-{info['api_key']}")
        # unknown principal shape: a stable hashed bucket, never the
        # repr (which could leak credentials into labels)
        try:
            basis = json.dumps(info, sort_keys=True, default=str)
        except (TypeError, ValueError):
            basis = str(sorted(info))
        return f"t-{credential_fingerprint(basis)}"

    def resolve(self, info: Mapping[str, Any] | None) -> str:
        label = self.label_for(info)
        with self._lock:
            if label in self._seen:
                return label
            if len(self._seen) >= self.max_tenants:
                return self.OTHER
            self._seen.add(label)
        return label


def _unauthorized(message: str = "Unauthorized",
                  scheme: str = "Basic") -> ResponseData:
    body = json.dumps({"error": {"message": message}}).encode()
    return ResponseData(status=401, body=body,
                        headers={"WWW-Authenticate": scheme})


def is_exempt(path: str) -> bool:
    return any(path.startswith(p) for p in EXEMPT_PREFIXES)


async def run_provider(provider: AuthProvider,
                       request: HTTPRequest) -> bool:
    """Authenticate and attach auth info to the request. The single
    authority for provider semantics — the middleware chain and the
    websocket upgrade path both call this."""
    info = provider.authenticate(request)
    if asyncio.iscoroutine(info):
        info = await info
    if info is None:
        return False
    # surfaced as ctx.auth_info by the core handler
    request.auth_info = info if isinstance(info, dict) else {"auth": info}
    return True


def auth_middleware(provider: AuthProvider,
                    scheme: str = "Basic") -> Middleware:
    """Generic auth wrapper (reference middleware/auth.go:39)."""

    def mw(next_handler: Handler) -> Handler:
        async def wrapped(request: HTTPRequest) -> ResponseData:
            if is_exempt(request.path):
                return await next_handler(request)
            try:
                ok = await run_provider(provider, request)
            except MissingDependency as exc:
                return _unauthorized(str(exc), scheme=scheme)
            if not ok:
                return _unauthorized(scheme=scheme)
            return await next_handler(request)
        return wrapped
    return mw


# --------------------------------------------------------------- basic

class BasicAuthProvider:
    """Username/password table or custom validator
    (reference basic_auth.go:116)."""

    def __init__(self, users: Mapping[str, str] | None = None,
                 validator: Callable[[str, str], bool | Awaitable[bool]] | None = None) -> None:
        self.users = dict(users or {})
        self.validator = validator

    def authenticate(self, request: HTTPRequest) -> dict | None:
        header = request.header("authorization")
        if not header.startswith("Basic "):
            return None
        try:
            decoded = base64.b64decode(header[6:], validate=True).decode()
        except (binascii.Error, UnicodeDecodeError):
            return None
        username, sep, password = decoded.partition(":")
        if not sep:
            return None
        if self.validator is not None:
            result = self.validator(username, password)
            if asyncio.iscoroutine(result):
                async def check():
                    return {"username": username} if await result else None
                return check()  # type: ignore[return-value]
            return {"username": username} if result else None
        expected = self.users.get(username)
        if expected is None or not hmac.compare_digest(expected.encode(),
                                                       password.encode()):
            return None
        return {"username": username}


# ------------------------------------------------------------- api key

class APIKeyAuthProvider:
    """Static key set or custom validator (reference apikey_auth.go:89).

    Keys ride in the ``X-Api-Key`` header. The raw key NEVER reaches
    the principal: ``auth_info["api_key"]`` carries its
    :func:`credential_fingerprint`, so nothing downstream (logs,
    spans, metric labels, /debug surfaces) can leak it. An optional
    ``key_names`` mapping (key -> tenant label) additionally stamps a
    human-chosen ``tenant`` into the principal — the label the tenant
    resolver and usage ledger account under."""

    def __init__(self, keys: list[str] | None = None,
                 validator: Callable[[str], bool | Awaitable[bool]] | None = None,
                 key_names: Mapping[str, str] | None = None) -> None:
        self.keys = set(keys or []) | set(key_names or {})
        self.validator = validator
        self.key_names = dict(key_names or {})

    def _info(self, key: str) -> dict:
        info = {"api_key": credential_fingerprint(key)}
        name = self.key_names.get(key)
        if name:
            info["tenant"] = name
        return info

    def authenticate(self, request: HTTPRequest) -> dict | None:
        key = request.header("x-api-key")
        if not key:
            return None
        if self.validator is not None:
            result = self.validator(key)
            if asyncio.iscoroutine(result):
                async def check():
                    return self._info(key) if await result else None
                return check()  # type: ignore[return-value]
            return self._info(key) if result else None
        if any(hmac.compare_digest(key.encode(), k.encode())
               for k in self.keys):
            return self._info(key)
        return None


# ----------------------------------------------------------------- jwt

def _b64url_decode(segment: str) -> bytes:
    pad = "=" * (-len(segment) % 4)
    return base64.urlsafe_b64decode(segment + pad)


def _b64url_to_int(segment: str) -> int:
    return int.from_bytes(_b64url_decode(segment), "big")


class JWTError(Exception):
    pass


class MissingDependency(JWTError):
    """RS256 needs ``cryptography``, which is not installed: the request
    is refused with a 401 that says so."""


def _require_cryptography() -> None:
    try:
        import cryptography  # noqa: F401
    except ImportError as exc:
        raise MissingDependency(
            "RS256 tokens need the 'cryptography' package, which is not "
            "installed on this server") from exc


def _verify_rs256(signing_input: bytes, signature: bytes, key: Any) -> bool:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding
    try:
        key.verify(signature, signing_input, padding.PKCS1v15(),
                   hashes.SHA256())
        return True
    except InvalidSignature:
        return False


def jwk_to_public_key(jwk: Mapping[str, Any]) -> Any:
    """RSA JWK (n, e) -> cryptography public key
    (reference oauth.go:183 key parsing)."""
    if jwk.get("kty") != "RSA":
        raise JWTError(f"unsupported kty {jwk.get('kty')!r}")
    _require_cryptography()
    from cryptography.hazmat.primitives.asymmetric.rsa import RSAPublicNumbers
    n = _b64url_to_int(jwk["n"])
    e = _b64url_to_int(jwk["e"])
    return RSAPublicNumbers(e, n).public_key()


def jwt_decode(token: str) -> tuple[dict, dict, bytes, bytes]:
    """Split a compact JWT -> (header, claims, signing_input, signature)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JWTError("token is not a compact JWT")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
        signature = _b64url_decode(parts[2])
    except (ValueError, binascii.Error) as exc:
        raise JWTError(f"malformed token: {exc}") from exc
    signing_input = f"{parts[0]}.{parts[1]}".encode()
    return header, claims, signing_input, signature


def jwt_verify(token: str, keys: Mapping[str, Any], *,
               audience: str | None = None, issuer: str | None = None,
               leeway: float = 30.0, now: float | None = None) -> dict:
    """Verify signature + registered claims; returns the claim set.

    ``keys`` maps kid -> RSA public key (cryptography object) or
    bytes/str HS256 secret. A single key under kid ``""`` is used when
    the token has no kid.
    """
    header, claims, signing_input, signature = jwt_decode(token)
    alg = header.get("alg")
    if alg == "RS256":
        _require_cryptography()
    kid = header.get("kid", "")
    key = keys.get(kid)
    if key is None and len(keys) == 1:
        key = next(iter(keys.values()))
    if key is None:
        raise JWTError(f"no key for kid {kid!r}")

    if alg == "RS256":
        if not hasattr(key, "verify"):  # str/bytes secret, raw JWK dict…
            raise JWTError("RS256 token but the key is not an RSA "
                           "public key object")
        if not _verify_rs256(signing_input, signature, key):
            raise JWTError("signature verification failed")
    elif alg == "HS256":
        # an RSA public key must never act as an HMAC secret — that is
        # the classic algorithm-confusion attack (attacker signs with
        # the PUBLIC key bytes and downgrades alg to HS256)
        if not isinstance(key, (str, bytes)):
            raise JWTError("HS256 token but the key is not a secret")
        secret = key.encode() if isinstance(key, str) else key
        expected = hmac.new(secret, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, signature):
            raise JWTError("signature verification failed")
    else:
        raise JWTError(f"unsupported alg {alg!r}")

    t = time.time() if now is None else now
    if "exp" in claims and t > float(claims["exp"]) + leeway:
        raise JWTError("token expired")
    if "nbf" in claims and t < float(claims["nbf"]) - leeway:
        raise JWTError("token not yet valid")
    if audience is not None:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise JWTError("audience mismatch")
    if issuer is not None and claims.get("iss") != issuer:
        raise JWTError("issuer mismatch")
    return claims


def jwt_sign_hs256(claims: Mapping[str, Any], secret: str | bytes,
                   headers: Mapping[str, Any] | None = None) -> str:
    """Mint an HS256 token (used by tests and service-to-service auth)."""
    secret = secret.encode() if isinstance(secret, str) else secret
    header = {"alg": "HS256", "typ": "JWT", **(headers or {})}

    def enc(obj: Mapping[str, Any]) -> str:
        raw = json.dumps(obj, separators=(",", ":")).encode()
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    signing_input = f"{enc(header)}.{enc(dict(claims))}"
    sig = hmac.new(secret, signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + base64.urlsafe_b64encode(sig).rstrip(b"=").decode()


class OAuthProvider:
    """Bearer-JWT validation against a JWKS set
    (reference oauth.go:69-138).

    Keys come from a ``jwks_url`` (refreshed at most every
    ``refresh_interval`` seconds, fetched lazily on demand — the
    background-goroutine analog without a dedicated thread), from a
    static ``jwks`` document, or from explicit ``keys``.
    """

    FAILURE_BACKOFF = 30.0

    def __init__(self, jwks_url: str | None = None, *,
                 jwks: Mapping[str, Any] | None = None,
                 keys: Mapping[str, Any] | None = None,
                 refresh_interval: float = 300.0,
                 audience: str | None = None, issuer: str | None = None,
                 logger: Any = None) -> None:
        self.jwks_url = jwks_url
        self.refresh_interval = refresh_interval
        self.audience = audience
        self.issuer = issuer
        self.logger = logger
        self._keys: dict[str, Any] = dict(keys or {})
        self._fetched_at = 0.0
        self._refresh_lock = __import__("threading").Lock()
        self._refreshing = False
        if jwks is not None:
            self._load_jwks(jwks)
            self._fetched_at = time.time()

    def _load_jwks(self, document: Mapping[str, Any]) -> None:
        for jwk in document.get("keys", []):
            try:
                self._keys[jwk.get("kid", "")] = jwk_to_public_key(jwk)
            except (JWTError, KeyError) as exc:
                if self.logger:
                    self.logger.warn(f"skipping unusable JWK: {exc}")

    def _fetch(self) -> None:
        import urllib.request
        try:
            with urllib.request.urlopen(self.jwks_url, timeout=5) as resp:
                self._load_jwks(json.loads(resp.read()))
            self._fetched_at = time.time()
        except Exception as exc:
            # advance the clock so a JWKS outage retries on a backoff
            # instead of on every request
            self._fetched_at = (time.time() - self.refresh_interval
                                + self.FAILURE_BACKOFF)
            if self.logger:
                self.logger.error(f"JWKS fetch failed: {exc!r}")
        finally:
            # cross-thread flag (background refresh thread vs request
            # threads taking _refresh_lock): reset under the same lock
            # that guards the test-and-set in _refresh_if_stale
            with self._refresh_lock:
                self._refreshing = False

    def _refresh_if_stale(self) -> None:
        if self.jwks_url is None:
            return
        stale = time.time() - self._fetched_at >= self.refresh_interval
        if not stale and self._keys:
            return
        with self._refresh_lock:
            if self._refreshing:
                return
            self._refreshing = True
        if self._keys:
            # have keys: refresh in the background, keep serving
            import threading
            threading.Thread(target=self._fetch, daemon=True).start()
        else:
            # cold start: nothing to validate against, fetch inline
            self._fetch()

    def authenticate(self, request: HTTPRequest) -> dict | None:
        header = request.header("authorization")
        if not header.startswith("Bearer "):
            return None
        self._refresh_if_stale()
        try:
            claims = jwt_verify(header[7:], self._keys,
                                audience=self.audience, issuer=self.issuer)
        except MissingDependency:
            raise
        except JWTError as exc:
            if self.logger:
                self.logger.debug(f"JWT rejected: {exc}")
            return None
        return {"claims": claims}
