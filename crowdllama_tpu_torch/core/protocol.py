"""Protocol identifiers and namespace constants.

A copy of ``crowdllama_tpu/core/protocol.py`` (the port imports nothing of
the JAX package): versioned protocol IDs for the app / metadata / inference
streams, the DHT key prefix, and the rendezvous namespace string whose
hashed key every peer advertises as a provider record.  The values must
stay equal to the JAX package's: a torch worker and a JAX worker join one
swarm.
"""

from __future__ import annotations

import hashlib

# Stream protocol IDs.
CROWDLLAMA_PROTOCOL = "/crowdllama/1.0.0"
METADATA_PROTOCOL = "/crowdllama/metadata/1.0.0"
INFERENCE_PROTOCOL = "/crowdllama/inference/1.0.0"
# Cross-worker model sharding: activation transfer between pipeline-stage
# workers of a shard group.
SHARD_PROTOCOL = "/crowdllama/shard/1.0.0"
# NAT traversal: reverse streams through a public relay node.
RELAY_PROTOCOL = "/crowdllama/relay/1.0.0"
# Connection reversal: a NATed worker dials a PUBLIC requester back
# directly, so only the signaling rides the relay.  This is the plaintext
# opening marker the reversed TCP connection presents at the requester's
# listener; the signed hello and AEAD handshake then run over it as usual.
REVERSE_PROTOCOL = "/crowdllama/reverse/1.0.0"
# Swarm model distribution: hash-verified safetensors transfer between
# workers.
MODEL_PROTOCOL = "/crowdllama/model/1.0.0"

# DHT key namespace prefix.
DHT_PREFIX = "/crowdllama/peer/"

# Rendezvous namespace advertised by every peer.
NAMESPACE = "crowdllama-ns"

# Default ports: the DHT bootstrap server and the gateway HTTP API.
DEFAULT_DHT_PORT = 9000
DEFAULT_GATEWAY_PORT = 9001


def namespace_key(namespace: str = NAMESPACE) -> bytes:
    """DHT content key for a rendezvous namespace: a raw 32-byte digest of
    the namespace string (one well-known key everyone provides)."""
    return hashlib.sha256(b"crowdllama-tpu:ns:" + namespace.encode()).digest()


def metadata_key(metadata_json: bytes) -> bytes:
    """Content key for a metadata blob (SHA2-256)."""
    return hashlib.sha256(b"crowdllama-tpu:meta:" + metadata_json).digest()
