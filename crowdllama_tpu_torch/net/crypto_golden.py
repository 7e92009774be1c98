"""Golden vectors of the swarm's crypto: the bytes the ``cryptography``
package (46.0.4, OpenSSL) produced for fixed inputs.

:func:`vectors` computes every case through a set of primitives
(``Primitives``): the port's ``utils/crypto.py`` here
(:func:`port_primitives`), ``cryptography``'s in
``tests/test_torch_crypto.py``, which regenerates the vectors and holds
both against :data:`VECTORS`.  ``chip_smoke.py`` runs :func:`check` on the
card's Python, which has no ``cryptography``: X25519 public keys and
shared secrets, Ed25519 public keys and signatures, ChaCha20-Poly1305
ciphertexts (with and without AAD, at 0, 1, 63, 64, 65 and 4096 bytes),
HKDF-SHA256 and the host's ``derive_keys``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable

AEAD_SIZES = (0, 1, 63, 64, 65, 4096)


@dataclass
class Primitives:
    x25519_public: Callable[[bytes], bytes]
    x25519_exchange: Callable[[bytes, bytes], bytes]
    ed25519_public: Callable[[bytes], bytes]
    ed25519_sign: Callable[[bytes, bytes], bytes]
    aead_encrypt: Callable[[bytes, bytes, bytes, bytes | None], bytes]
    hkdf: Callable[[bytes, int, bytes, bytes], bytes]


def port_primitives() -> Primitives:
    from crowdllama_tpu_torch.utils import crypto as c

    return Primitives(
        x25519_public=lambda k: c.X25519PrivateKey.from_private_bytes(
            k).public_key().public_bytes_raw(),
        x25519_exchange=lambda k, pub: c.X25519PrivateKey.from_private_bytes(
            k).exchange(c.X25519PublicKey.from_public_bytes(pub)),
        ed25519_public=lambda s: c.Ed25519PrivateKey.from_private_bytes(
            s).public_key().public_bytes_raw(),
        ed25519_sign=lambda s, m: c.Ed25519PrivateKey.from_private_bytes(
            s).sign(m),
        aead_encrypt=lambda k, n, d, a: c.ChaCha20Poly1305(k).encrypt(n, d, a),
        hkdf=lambda ikm, n, salt, info: c.hkdf_sha256(ikm, n, salt, info))


def _det(label: str, n: int) -> bytes:
    """``n`` fixed bytes named by ``label``."""
    return hashlib.shake_256(b"crowdllama-crypto-golden|"
                             + label.encode()).digest(n)


def _hex(data: bytes) -> str:
    """Hex of ``data``, or of its SHA-256 past 256 bytes."""
    if len(data) > 256:
        return "sha256:" + hashlib.sha256(data).hexdigest()
    return data.hex()


def vectors(p: Primitives) -> dict[str, str]:
    """Case name -> hex of what primitives ``p`` give for it."""
    out: dict[str, str] = {}
    a, b = _det("x25519-a", 32), _det("x25519-b", 32)
    pub_a, pub_b = p.x25519_public(a), p.x25519_public(b)
    out["x25519_public_a"] = pub_a.hex()
    out["x25519_public_b"] = pub_b.hex()
    out["x25519_shared_ab"] = p.x25519_exchange(a, pub_b).hex()
    out["x25519_shared_ba"] = p.x25519_exchange(b, pub_a).hex()
    seed = _det("ed25519-seed", 32)
    out["ed25519_public"] = p.ed25519_public(seed).hex()
    for name, msg in (("empty", b""), ("hello", _det("hello", 91))):
        out[f"ed25519_sig_{name}"] = p.ed25519_sign(seed, msg).hex()
    key, nonce = _det("aead-key", 32), _det("aead-nonce", 12)
    for n in AEAD_SIZES:
        data = _det(f"aead-data-{n}", n)
        out[f"aead_{n}"] = _hex(p.aead_encrypt(key, nonce, data, None))
        out[f"aead_{n}_aad"] = _hex(p.aead_encrypt(
            key, nonce, data, _det(f"aead-aad-{n}", 13)))
    out["hkdf_64"] = p.hkdf(_det("hkdf-ikm", 32), 64, b"salt",
                            b"info").hex()
    # The host's derive_keys: HKDF of the ECDH secret with its salt/info.
    info = "|".join(["crowdllama-tpu-secure-v2", "/crowdllama/1.0.0",
                     "client", "server", "cn", "sn"]).encode()
    out["derive_keys"] = p.hkdf(p.x25519_exchange(a, pub_b), 64,
                                b"crowdllama-tpu-hkdf-salt", info).hex()
    return out


VECTORS = {
    "x25519_public_a":
        "887c513bce5b42ba1ac35178e737ebec00a66e8be3b4acd97c7e08d2591b8c78",
    "x25519_public_b":
        "cc4b3b34a62942bfad0ea324d2ec2d9f44092144ccd07a6b11117f06b71a2462",
    "x25519_shared_ab":
        "2f44338b99c54b75755c2ba3c4a856864f591bb8b9923a673527bfd03ff4ac31",
    "x25519_shared_ba":
        "2f44338b99c54b75755c2ba3c4a856864f591bb8b9923a673527bfd03ff4ac31",
    "ed25519_public":
        "b8701892107e0c096355f1304b6eddde021ffc5b86d924e3575d67215c8ea9c0",
    "ed25519_sig_empty":
        "758aec9785b3e21f3dd281b71a3712bfcfc365cc94ebf73dcede8b4f78b3f61d"
        "748e4f565e26149d37f0a04cf5955b85f125dde5e8e42f9f97d8125320024c0b",
    "ed25519_sig_hello":
        "48e8802b357f5db44c5040db720243df93db3afa13cd42d7c2948492f5bd2fef"
        "29b4a5e9313fb733cdb2a2717805c44b4a8ae548e2e5b0b326c91d130176bd0b",
    "aead_0": "f47dc5e7e777259833fa66fd57014c3b",
    "aead_0_aad": "2120b45f008ee92575955c8d4cf60e1e",
    "aead_1": "899d7f6d06913ba0e70db138e0364296fd",
    "aead_1_aad": "897c5365967d8d9c281be6a6ecea5b9868",
    "aead_63":
        "34180513100273f241e076febd339bea29e20f12ffaa201eb53b8b2be44bf9ec"
        "17159218404f36df63ac0b3627d0badf77d5d1f965e007ac7ae5f1e31c1d3f51"
        "f912b21d5a1b4f855398ddffb2e460",
    "aead_63_aad":
        "34180513100273f241e076febd339bea29e20f12ffaa201eb53b8b2be44bf9ec"
        "17159218404f36df63ac0b3627d0badf77d5d1f965e007ac7ae5f1e31c1d3f42"
        "bc52ac340f559588ba182c871c6ebf",
    "aead_64":
        "e51fdd4239ade1bf0c47770dc6ee40ec4b6560e7985ae708c64142f317b0e990"
        "47bdde31bc7ea195a27986c141323a084e6342e3de8df8770bc8cd11108059b5"
        "7e91252a5814dc2b5575249d0b5769a9",
    "aead_64_aad":
        "e51fdd4239ade1bf0c47770dc6ee40ec4b6560e7985ae708c64142f317b0e990"
        "47bdde31bc7ea195a27986c141323a084e6342e3de8df8770bc8cd11108059b5"
        "d7b33cc896d8176b8eec48c0e39bc19f",
    "aead_65":
        "4b8cb5b33cb6a0065fe18f4f1a51eb6024a2800658bdd6d11547e6e251f8a8fb"
        "2410ac4756606ae37a9b32e3fab0831b7bedf05f3e84ddf43b994aa33994551a"
        "0db3810b1c01d7a91d65c63767554664c0",
    "aead_65_aad":
        "4b8cb5b33cb6a0065fe18f4f1a51eb6024a2800658bdd6d11547e6e251f8a8fb"
        "2410ac4756606ae37a9b32e3fab0831b7bedf05f3e84ddf43b994aa33994551a"
        "0d0f1dba263231cecfc600ee520927a86e",
    "aead_4096":
        "sha256:ef9f36e326e0f8d3eb06fac22f8b9c9a34557a1169ccc906994ec71e2"
        "fa52cb4",
    "aead_4096_aad":
        "sha256:e7873af1b623610578f3edd691b88d957a44cdd6ff3c2aa6370282ce7"
        "29fe072",
    "hkdf_64":
        "1044437ab44d72d67e9602d65558b0608570a9d84b68fba9fd09a980a265ab7b"
        "75eced9f392947e0b305fb62ae6f3551581d145bd0465ac3979aeed2395a24a2",
    "derive_keys":
        "7c67cafe5b09b79513be82b3a7737bed9b6668c98d625d8aac1aee0c0d42bb7d"
        "b33e521e18e17144881ba10d11ac7fc5f68a00570b99ce408eb06dc6911f607b",
}


def check() -> dict:
    """The port reproduces every vector; its verify accepts each golden
    signature and its AEAD opens each ciphertext (equal to the goldens);
    a flipped bit in a signature or a tag is refused.  Raises
    AssertionError."""
    from crowdllama_tpu_torch.net.secure import derive_keys
    from crowdllama_tpu_torch.utils import crypto as c

    got = vectors(port_primitives())
    bad = {k: (v, VECTORS.get(k)) for k, v in got.items()
           if v != VECTORS.get(k)}
    if set(got) != set(VECTORS):
        bad["cases"] = (sorted(got), sorted(VECTORS))
    shared = c.X25519PrivateKey(_det("x25519-a", 32)).exchange(c.X25519PublicKey(
        bytes.fromhex(VECTORS["x25519_public_b"])))
    if b"".join(derive_keys(shared, "/crowdllama/1.0.0", "client", "server",
                            "cn", "sn")).hex() != VECTORS["derive_keys"]:
        bad["derive_keys:host"] = "differs"
    pub = c.Ed25519PublicKey(bytes.fromhex(VECTORS["ed25519_public"]))
    for name, msg in (("empty", b""), ("hello", _det("hello", 91))):
        sig = bytes.fromhex(VECTORS[f"ed25519_sig_{name}"])
        pub.verify(sig, msg)
        forged = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        try:
            pub.verify(forged, msg)
            bad[f"forged_sig_{name}"] = "accepted"
        except c.InvalidSignature:
            pass
    aead = c.ChaCha20Poly1305(_det("aead-key", 32))
    nonce = _det("aead-nonce", 12)
    for n in AEAD_SIZES:
        aad = _det(f"aead-aad-{n}", 13)
        ct = aead.encrypt(nonce, _det(f"aead-data-{n}", n), aad)
        if aead.decrypt(nonce, ct, aad) != _det(f"aead-data-{n}", n):
            bad[f"open_{n}"] = "differs"
        try:
            aead.decrypt(nonce, ct[:-1] + bytes([ct[-1] ^ 1]), aad)
            bad[f"forged_tag_{n}"] = "accepted"
        except c.InvalidTag:
            pass
    if bad:
        raise AssertionError(f"crypto goldens differ (got, want): {bad}")
    return {"vectors": len(VECTORS)}
