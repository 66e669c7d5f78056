"""The port's auth (``gofr_tpu_torch/http/auth.py``) against the JAX
package's on the same requests and tokens.

Compared exactly: each provider's principal (or refusal) for the same
headers — basic with a user table and with a validator (plain and
async), API keys with ``key_names`` and with a validator; HS256 tokens
minted by both are the same bytes, and ``jwt_verify`` gives the same
claims or the same error message (expired, not yet valid, audience,
issuer, bad signature, an unknown alg, the HS256/RS256 algorithm
confusion); RS256 through ``OAuthProvider`` against a JWKS served by a
local HTTP server; the middleware's 401 (status, ``WWW-Authenticate``,
body bytes) and its ``/.well-known`` exemption; ``TenantResolver``
labels and its cardinality cap. On the port alone: where
``cryptography`` cannot be imported (the card's machine), an RS256
token draws a 401 whose message names the package, and HS256 still
works.
"""

import asyncio
import base64
import http.server
import json
import sys
import threading
import time

import pytest

from gofr_tpu.http import auth as jauth
from gofr_tpu.http.request import HTTPRequest as JaxRequest
from gofr_tpu.http.responder import ResponseData as JaxResponseData
from gofr_tpu_torch.http import auth as tauth
from gofr_tpu_torch.http.request import HTTPRequest
from gofr_tpu_torch.http.responder import ResponseData

from .torch_parity import time_limit

SIDES = {"port": (tauth, HTTPRequest, ResponseData),
         "jax": (jauth, JaxRequest, JaxResponseData)}


def _basic(user, pw):
    return "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()


HEADER_SETS = [
    {}, {"Authorization": _basic("ann", "pw1")},
    {"Authorization": _basic("ann", "wrong")},
    {"Authorization": _basic("bob", "pw2")},
    {"Authorization": "Basic !!notbase64"},
    {"Authorization": "Basic " + base64.b64encode(b"nocolon").decode()},
    {"Authorization": "Bearer abc"},
    {"X-Api-Key": "k-one"}, {"X-Api-Key": "k-two"}, {"X-Api-Key": "bad"},
    {"X-Api-Key": ""}]


def _providers(mod):
    async def async_user(user, pw):
        return pw == "pw2"
    return {
        "basic": mod.BasicAuthProvider({"ann": "pw1"}),
        "basic_validator": mod.BasicAuthProvider(
            validator=lambda u, p: u == "bob" and p == "pw2"),
        "basic_async": mod.BasicAuthProvider(validator=async_user),
        "api_key": mod.APIKeyAuthProvider(["k-one"],
                                          key_names={"k-two": "team-b"}),
        "api_key_validator": mod.APIKeyAuthProvider(
            validator=lambda k: k.startswith("k-")),
    }


def _outcomes(side):
    mod, request_cls, _ = SIDES[side]
    out = {}
    for name, provider in _providers(mod).items():
        for i, headers in enumerate(HEADER_SETS):
            request = request_cls("GET", "/x", headers)
            ok = asyncio.run(mod.run_provider(provider, request))
            out[(name, i)] = (ok, getattr(request, "auth_info", None))
    return out


def test_basic_and_api_key_providers_like_jax():
    assert _outcomes("port") == _outcomes("jax")


def _middleware(side, provider_name, scheme, path, headers):
    mod, request_cls, response_cls = SIDES[side]
    provider = _providers(mod)[provider_name]

    async def core(request):
        return response_cls(status=200, body=json.dumps(
            getattr(request, "auth_info", None)).encode())

    handler = mod.auth_middleware(provider, scheme=scheme)(core)
    r = asyncio.run(handler(request_cls("POST", path, headers)))
    return r.status, r.headers, r.body


@pytest.mark.parametrize("provider,scheme", [("basic", "Basic"),
                                             ("api_key", "ApiKey")])
@pytest.mark.parametrize("path", ["/chat", "/.well-known/health"])
def test_middleware_401_and_exemption_like_jax(provider, scheme, path):
    for headers in HEADER_SETS:
        assert _middleware("port", provider, scheme, path, headers) == \
            _middleware("jax", provider, scheme, path, headers)


def test_tenant_resolver_like_jax():
    infos = [None, {}, {"tenant": "team a/b"}, {"username": "ann"},
             {"claims": {"org": "acme", "sub": "u1"}},
             {"claims": {"sub": "u2"}}, {"api_key": "abc123"},
             {"auth": "opaque"}, {"x": object()}]
    got = tauth.TenantResolver(max_tenants=4)
    want = jauth.TenantResolver(max_tenants=4)
    labels = [got.resolve(i) for i in infos]
    assert labels == [want.resolve(i) for i in infos]
    assert labels.count("other") == 4        # past the cap of 4
    assert tauth.credential_fingerprint("s3cret") == \
        jauth.credential_fingerprint("s3cret")


# ------------------------------------------------------------------ JWT
NOW = 1_700_000_000


def _verify(mod, token, keys, **kw):
    try:
        return ("ok", mod.jwt_verify(token, keys, now=NOW, **kw))
    except mod.JWTError as exc:
        return ("JWTError", str(exc))


HS_CASES = [({"sub": "u", "exp": NOW + 60}, {}),
            ({"sub": "u", "exp": NOW - 100}, {}),
            ({"sub": "u", "nbf": NOW + 100}, {}),
            ({"sub": "u", "aud": ["a", "b"]}, {"audience": "b"}),
            ({"sub": "u", "aud": "a"}, {"audience": "c"}),
            ({"sub": "u", "iss": "me"}, {"issuer": "you"}),
            ({"sub": "u", "iss": "me"}, {"issuer": "me"})]


@pytest.mark.parametrize("claims,kw", HS_CASES)
def test_hs256_tokens_and_verification_like_jax(claims, kw):
    token = tauth.jwt_sign_hs256(claims, "secret", {"kid": "k1"})
    assert token == jauth.jwt_sign_hs256(claims, "secret", {"kid": "k1"})
    for keys in ({"k1": "secret"}, {"k1": "other"}, {"zz": "secret"},
                 {"a": "secret", "b": "secret"}):
        assert _verify(tauth, token, keys, **kw) == \
            _verify(jauth, token, keys, **kw)


def test_malformed_and_unknown_alg_tokens_like_jax():
    def enc(obj):
        return base64.urlsafe_b64encode(
            json.dumps(obj).encode()).rstrip(b"=").decode()
    tokens = ["a.b", "not.a.token", enc({"alg": "none"}) + "."
              + enc({"sub": "x"}) + ".", enc({"alg": "ES256"}) + "."
              + enc({}) + ".c2ln"]
    for token in tokens:
        assert _verify(tauth, token, {"": "s"}) == \
            _verify(jauth, token, {"": "s"})


@pytest.fixture(scope="module")
def rsa():
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    numbers = key.public_key().public_numbers()

    def b64int(n):
        raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    def sign(claims, kid="rk1", alg="RS256"):
        def enc(obj):
            return base64.urlsafe_b64encode(json.dumps(
                obj, separators=(",", ":")).encode()).rstrip(b"=").decode()
        signing = f"{enc({'alg': alg, 'kid': kid})}.{enc(claims)}"
        sig = key.sign(signing.encode(), padding.PKCS1v15(), hashes.SHA256())
        return signing + "." + base64.urlsafe_b64encode(sig).rstrip(
            b"=").decode()

    jwks = {"keys": [{"kty": "RSA", "kid": "rk1", "n": b64int(numbers.n),
                      "e": b64int(numbers.e)}, {"kty": "EC", "kid": "ec"}]}
    pem = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    return sign, jwks, pem


@pytest.fixture(scope="module")
def jwks_url(rsa):
    """The JWKS document from a local HTTP server."""
    body = json.dumps(rsa[1]).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server's naming
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/jwks.json"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def _bearer(side, url, token, **kw):
    mod, request_cls, response_cls = SIDES[side]
    provider = mod.OAuthProvider(url, **kw)

    async def core(request):
        return response_cls(status=200, body=json.dumps(
            request.auth_info).encode())

    handler = mod.auth_middleware(provider, scheme="Bearer")(core)
    r = asyncio.run(handler(request_cls(
        "GET", "/chat", {"Authorization": f"Bearer {token}"})))
    return r.status, r.headers, r.body


@time_limit(60)
def test_rs256_against_a_local_jwks_like_jax(rsa, jwks_url):
    sign = rsa[0]
    exp = int(time.time()) + 600
    good = sign({"sub": "u1", "org": "acme", "exp": exp})
    tampered = good[:-6] + ("AAAAAA" if not good.endswith("AAAAAA")
                            else "BBBBBB")
    wrong_kid = sign({"sub": "u1", "exp": exp}, kid="nope")
    expired = sign({"sub": "u1", "exp": 1000})
    # algorithm confusion: HS256 signed with the public key's PEM
    confused = tauth.jwt_sign_hs256({"sub": "evil"}, rsa[2].decode(),
                                    {"kid": "rk1"})
    answers = {}
    for token in (good, tampered, wrong_kid, expired, confused):
        got = _bearer("port", jwks_url, token, audience=None)
        assert got == _bearer("jax", jwks_url, token, audience=None)
        answers[token] = got
    assert answers[good][0] == 200
    assert json.loads(answers[good][2])["claims"]["org"] == "acme"
    assert all(answers[t][0] == 401 for t in (tampered, expired, confused))
    # one usable key in the set: both packages verify an unknown kid
    # against it (jwt_verify's single-key rule)
    assert answers[wrong_kid][0] == 200
    assert tauth.TenantResolver().resolve(
        json.loads(answers[good][2])) == "acme"


@time_limit(60)
def test_rs256_without_cryptography_is_a_typed_401(rsa, jwks_url,
                                                   monkeypatch):
    """The card's machine has no ``cryptography``: the RSA JWK is skipped
    and an RS256 token is refused with a 401 naming the package; an
    HS256 token still passes."""
    token = rsa[0]({"sub": "u1", "exp": int(time.time()) + 600})
    for name in [m for m in sys.modules if m == "cryptography"
                 or m.startswith("cryptography.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    status, headers, body = _bearer("port", jwks_url, token)
    assert (status, headers) == (401, {"WWW-Authenticate": "Bearer"})
    message = json.loads(body)["error"]["message"]
    assert "cryptography" in message and "RS256" in message
    hs = tauth.jwt_sign_hs256({"sub": "u2"}, "s")
    provider = tauth.OAuthProvider(keys={"": "s"})
    request = HTTPRequest("GET", "/x", {"Authorization": f"Bearer {hs}"})
    assert provider.authenticate(request) == {"claims": {"sub": "u2"}}
