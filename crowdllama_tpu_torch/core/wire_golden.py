"""Golden llama.v1 frames: the bytes protobuf's Python runtime (6.33)
produced, through the JAX package's ``core/messages.py``, for fixed
messages (``created_ns`` pinned to :data:`CREATED_NS`).

:func:`frames` builds each case with a messages module whose constructors
have the JAX package's signatures: the port's ``core/messages.py`` here,
the JAX package's in ``tests/test_torch_wire.py``, which holds both
against :data:`FRAMES`.  ``chip_smoke.py`` holds the port's encoder and
decoder against them on the card's Python, which has no protobuf
(:func:`check`).
"""

from __future__ import annotations

import struct

CREATED_NS = 1_760_000_000_123_456_789
MODEL = "tinyllama-1.1b"


def frames(m) -> dict[str, bytes]:
    """Case name -> the frame ([4-byte big-endian length][BaseMessage])
    that messages module ``m`` builds for it."""
    def enc(msg) -> bytes:
        payload = msg.SerializeToString()
        return struct.pack(">I", len(payload)) + payload

    traced = m.migrate_frame_msg(
        MODEL, "worker-a", delivered_tokens=7, prompt_tokens=300,
        chain_hashes=[bytes(range(32)), b"\xff" * 32], page_size=128)
    traced.trace_id = "trace-1"
    traced.parent_span = "gateway"
    return {
        "generate_request": enc(m.create_generate_request(
            MODEL, prompt="héllo, wörld ☃", stream=True,
            messages=[{"role": "system", "content": "be brief"},
                      {"role": "user", "content": "hi"}],
            max_tokens=32, temperature=0.8, top_p=0.9, seed=2**64 - 1,
            stop=["\n\n", "END"], top_k=20, repeat_penalty=1.1)),
        "generate_request_empty": enc(m.create_generate_request("")),
        "generate_request_negative": enc(m.create_generate_request(
            MODEL, "p", max_tokens=-1, temperature=-0.0, top_k=-20)),
        "generate_response_chunk": m.genresp_frame_bytes(
            MODEL, "tok", worker_id="worker-a", done=False,
            trace_id="trace-1", created_ns=CREATED_NS),
        "generate_response_final": m.genresp_frame_bytes(
            MODEL, "", worker_id="worker-a", done=True, done_reason="length",
            total_duration_ns=1_234_567_890, prompt_tokens=300,
            completion_tokens=32, trace_id="trace-1", parent_span="gateway",
            created_ns=CREATED_NS),
        "generate_response_epoch": m.genresp_frame_bytes(
            MODEL, "a", done=True, created_ns=0),
        "embed_request": enc(m.create_embed_request(
            MODEL, ["alpha", "β"], truncate=True)),
        "embed_response": enc(m.create_embed_response(
            MODEL, [[0.5, -0.0, 1 / 3, -2.5e-8], [], [1e30]],
            worker_id="worker-a", total_duration_ns=42, prompt_tokens=9)),
        "migrate_frame": enc(traced),
        "kv_fetch_request": enc(m.create_kv_fetch_request(
            MODEL, [b"\x00" * 32, b"\x01" * 32], 16)),
        "gossip_frame": enc(m.gossip_frame_msg(
            "gw-1", entries=[{"key": "aff/x", "value": "w", "version": 2**40,
                              "tombstone": True, "origin": "gw-1"},
                             {"key": "quar/y"}],
            usage=[{"origin": "gw-1", "tenant": "hot", "admitted": 3,
                    "version": 5}],
            sync=True, clock=2**63)),
        "trace_spans": enc(m.trace_spans_msg(
            "trace-1", node="worker:ab", payload=b'{"spans": []}',
            found=True)),
        "metrics_fetch": enc(m.metrics_fetch_msg(["crowdllama_engine"])),
        "metrics_snapshot": enc(m.metrics_snapshot_msg(
            node="worker:ab", payload=b"# HELP x\n", found=True, error="")),
        "draft_chunk": enc(m.draft_chunk_msg(
            MODEL, chunk_id=9, position=301, tokens=[5, 0, 70000])),
        "verify_result": enc(m.verify_result_msg(
            chunk_id=0, position=1, accepted=0, tokens=[-1, 2], done=False,
            draft_k=4, depth_hint=2, prompt_ids=[257, 104, 105])),
    }


# The frames protobuf produced for each case (hex).
FRAMES = {
    "generate_request":
        "0000006f0a6d0a0e74696e796c6c616d612d312e3162121268c3a96c6c6f"
        "2c2077c3b6726c6420e29883180122120a0673797374656d120862652062"
        "72696566220a0a047573657212026869282035cdcc4c3f3d6666663f40ff"
        "ffffffffffffffff014a020a0a4a03454e4450145dcdcc8c3f",
    "generate_request_empty":
        "000000020a00",
    "generate_request_negative":
        "000000300a2e0a0e74696e796c6c616d612d312e316212017028ffffffff"
        "ffffffffff01350000008050ecffffffffffffffff01",
    "generate_response_chunk":
        "00000037122c0a0e74696e796c6c616d612d312e3162120b0880f09dc706"
        "10959aef3a1a03746f6b3208776f726b65722d612a0774726163652d31",
    "generate_response_final":
        "00000050123c0a0e74696e796c6c616d612d312e3162120b0880f09dc706"
        "10959aef3a20012a066c656e6774683208776f726b65722d6138d285d8cc"
        "0440ac0248202a0774726163652d31320767617465776179",
    "generate_response_epoch":
        "0000001f121d0a0e74696e796c6c616d612d312e316212001a016120012a"
        "0473746f70",
    "embed_request":
        "0000001f1a1d0a0e74696e796c6c616d612d312e31621205616c70686112"
        "02ceb21801",
    "embed_response":
        "0000003e223c0a0e74696e796c6c616d612d312e316212120a100000003f"
        "00000080abaaaa3e95bfd6b2120012060a04caf249711a08776f726b6572"
        "2d61202a2809",
    "migrate_frame":
        "000000812a0774726163652d313207676174657761794a6d0a0e74696e79"
        "6c6c616d612d312e31621208776f726b65722d61180720ac022a20000102"
        "030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f2a"
        "20ffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
        "ffffff3080013a05647261696e",
    "kv_fetch_request":
        "000000583a560a0e74696e796c6c616d612d312e31621220000000000000"
        "000000000000000000000000000000000000000000000000000012200101"
        "010101010101010101010101010101010101010101010101010101010101"
        "1810",
    "gossip_frame":
        "0000004b52490a0467772d3112190a056166662f78120177188080808080"
        "2020012a0467772d3112080a06717561722f791a0f0a0467772d31120368"
        "6f741803200520012880808080808080808001",
    "trace_spans":
        "0000002762250a0774726163652d311209776f726b65723a61621a0d7b22"
        "7370616e73223a205b5d7d2001",
    "metrics_fetch":
        "000000156a130a1163726f77646c6c616d615f656e67696e65",
    "metrics_snapshot":
        "0000001a72180a09776f726b65723a61621209232048454c5020780a1801",
    "draft_chunk":
        "0000001e7a1c0a0e74696e796c6c616d612d312e3162100918ad02220505"
        "00f0a204",
    "verify_result":
        "0000001c8201191001220bffffffffffffffffff01023004380242048102"
        "6869",
}


def check() -> dict:
    """The port's encoder reproduces every golden frame, and its decoder
    reads each golden frame back into the message the port built (which
    re-encodes to the same bytes); raises AssertionError on a mismatch."""
    from crowdllama_tpu_torch.core import messages, wire

    built = frames(messages)
    bad = {k: (v.hex(), FRAMES[k]) for k, v in built.items()
           if v.hex() != FRAMES[k]}
    if set(built) != set(FRAMES):
        bad["cases"] = (sorted(built), sorted(FRAMES))
    for name, hx in FRAMES.items():
        golden = bytes.fromhex(hx)
        msg = wire.decode_payload(golden[4:])
        if (msg != wire.decode_payload(built[name][4:])
                or wire.encode_frame(msg) != golden):
            bad[f"decode:{name}"] = repr(msg)
    if bad:
        raise AssertionError(f"wire goldens differ (got, want): {bad}")
    return {"frames": len(FRAMES),
            "bytes": sum(len(hx) // 2 for hx in FRAMES.values())}
