"""The port's handshake crypto (``crowdllama_tpu_torch/utils/crypto.py``)
against the ``cryptography`` package, the library a JAX node puts on the
wire: X25519 public keys and exchanges, Ed25519 public keys, signatures
and verification, ChaCha20-Poly1305 (RFC 8439) seal and open with and
without AAD at 0, 1, 63, 64, 65 and 4096 bytes and at drawn sizes, and
HKDF-SHA256, each byte-equal on hypothesis-drawn keys and messages.
Forged tags and signatures raise ``InvalidTag`` / ``InvalidSignature``.
The golden vectors of ``net/crypto_golden.py`` are regenerated through
``cryptography`` and compared with the file, and its ``check()`` (what
``chip_smoke.py`` runs on the card) passes here.
"""

import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from crowdllama_tpu_torch.net import crypto_golden
from crowdllama_tpu_torch.utils import crypto as port

ref_ed = pytest.importorskip(
    "cryptography.hazmat.primitives.asymmetric.ed25519")
from cryptography.exceptions import InvalidSignature, InvalidTag  # noqa: E402
from cryptography.hazmat.primitives.asymmetric import x25519 as ref_x  # noqa: E402
from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: E402
    ChaCha20Poly1305,
)
from cryptography.hazmat.primitives.hashes import SHA256  # noqa: E402
from cryptography.hazmat.primitives.kdf.hkdf import HKDF  # noqa: E402

KEY = st.binary(min_size=32, max_size=32)
NONCE = st.binary(min_size=12, max_size=12)
SIZES = (0, 1, 63, 64, 65, 4096)
FEW = settings(max_examples=25, deadline=None)


def _ref_primitives() -> crypto_golden.Primitives:
    return crypto_golden.Primitives(
        x25519_public=lambda k: ref_x.X25519PrivateKey.from_private_bytes(
            k).public_key().public_bytes_raw(),
        x25519_exchange=lambda k, pub: ref_x.X25519PrivateKey
        .from_private_bytes(k).exchange(
            ref_x.X25519PublicKey.from_public_bytes(pub)),
        ed25519_public=lambda s: ref_ed.Ed25519PrivateKey.from_private_bytes(
            s).public_key().public_bytes_raw(),
        ed25519_sign=lambda s, m: ref_ed.Ed25519PrivateKey
        .from_private_bytes(s).sign(m),
        aead_encrypt=lambda k, n, d, a: ChaCha20Poly1305(k).encrypt(n, d, a),
        hkdf=lambda ikm, n, salt, info: HKDF(
            algorithm=SHA256(), length=n, salt=salt, info=info).derive(ikm))


@FEW
@given(a=KEY, b=KEY)
def test_x25519_equals_cryptography(a, b):
    ra, rb = (ref_x.X25519PrivateKey.from_private_bytes(k) for k in (a, b))
    pa = port.X25519PrivateKey.from_private_bytes(a)
    assert (pa.public_key().public_bytes_raw()
            == ra.public_key().public_bytes_raw())
    pub_b = rb.public_key().public_bytes_raw()
    assert (pa.exchange(port.X25519PublicKey.from_public_bytes(pub_b))
            == ra.exchange(rb.public_key()))


@FEW
@given(seed=KEY, msg=st.binary(max_size=300))
def test_ed25519_equals_cryptography(seed, msg):
    ref = ref_ed.Ed25519PrivateKey.from_private_bytes(seed)
    key = port.Ed25519PrivateKey.from_private_bytes(seed)
    pub = ref.public_key().public_bytes_raw()
    assert key.public_key().public_bytes_raw() == pub
    sig = key.sign(msg)
    assert sig == ref.sign(msg)
    # Each side verifies the other's signature.
    port.Ed25519PublicKey.from_public_bytes(pub).verify(ref.sign(msg), msg)
    ref.public_key().verify(sig, msg)


@settings(max_examples=10, deadline=None)
@given(seed=KEY, msg=st.binary(max_size=64), bit=st.integers(0, 511))
def test_forged_signature_raises(seed, msg, bit):
    key = port.Ed25519PrivateKey.from_private_bytes(seed)
    pub = key.public_key()
    sig = bytearray(key.sign(msg))
    sig[bit // 8] ^= 1 << (bit % 8)
    with pytest.raises(port.InvalidSignature):
        pub.verify(bytes(sig), msg)
    with pytest.raises(InvalidSignature):
        ref_ed.Ed25519PublicKey.from_public_bytes(
            pub.public_bytes_raw()).verify(bytes(sig), msg)
    with pytest.raises(port.InvalidSignature):
        pub.verify(key.sign(msg), msg + b"x")


@pytest.mark.parametrize("aad", [None, b"header"], ids=["no_aad", "aad"])
@pytest.mark.parametrize("size", SIZES)
def test_aead_sizes_equal_cryptography(size, aad):
    key, nonce, data = os.urandom(32), os.urandom(12), os.urandom(size)
    ct = port.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
    assert ct == ChaCha20Poly1305(key).encrypt(nonce, data, aad)
    assert port.ChaCha20Poly1305(key).decrypt(nonce, ct, aad) == data


@FEW
@given(key=KEY, nonce=NONCE, data=st.binary(max_size=700),
       aad=st.one_of(st.none(), st.binary(max_size=40)))
def test_aead_equals_cryptography(key, nonce, data, aad):
    ct = ChaCha20Poly1305(key).encrypt(nonce, data, aad)
    assert port.ChaCha20Poly1305(key).encrypt(nonce, data, aad) == ct
    assert port.ChaCha20Poly1305(key).decrypt(nonce, ct, aad) == data


@settings(max_examples=15, deadline=None)
@given(key=KEY, nonce=NONCE, data=st.binary(max_size=200),
       bit=st.integers(0, 8 * 216 - 1))
def test_forged_aead_raises(key, nonce, data, bit):
    aead = port.ChaCha20Poly1305(key)
    ct = bytearray(aead.encrypt(nonce, data, b"aad"))
    ct[(bit // 8) % len(ct)] ^= 1 << (bit % 8)
    with pytest.raises(port.InvalidTag):
        aead.decrypt(nonce, bytes(ct), b"aad")
    with pytest.raises(InvalidTag):
        ChaCha20Poly1305(key).decrypt(nonce, bytes(ct), b"aad")
    good = aead.encrypt(nonce, data, b"aad")
    with pytest.raises(port.InvalidTag):
        aead.decrypt(nonce, good, b"other aad")
    with pytest.raises(port.InvalidTag):
        aead.decrypt(nonce, good[:15], b"aad")


@FEW
@given(ikm=st.binary(max_size=64), salt=st.binary(max_size=40),
       info=st.binary(max_size=40), length=st.integers(1, 200))
def test_hkdf_equals_cryptography(ikm, salt, info, length):
    want = HKDF(algorithm=SHA256(), length=length, salt=salt or None,
                info=info).derive(ikm)
    assert port.hkdf_sha256(ikm, length, salt=salt or None, info=info) == want


def test_golden_vectors_are_cryptographys_and_the_ports():
    assert crypto_golden.vectors(_ref_primitives()) == crypto_golden.VECTORS
    assert crypto_golden.check() == {"vectors": len(crypto_golden.VECTORS)}
