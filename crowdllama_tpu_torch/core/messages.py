"""Constructors and extractors for llama.v1 wire messages.

Counterpart of ``crowdllama_tpu/core/messages.py``, over the port's own
codec (``core/llama_v1.py``): one constructor and one extractor per
``BaseMessage`` arm, ``genresp_frame_bytes`` (a streamed
``GenerateResponse`` frame straight from scalars) and ``flatten_chat``.
"""

from __future__ import annotations

import time
from typing import Iterable, Mapping

from crowdllama_tpu_torch.core import llama_v1 as pb
from crowdllama_tpu_torch.core import wire


def _extract(msg: pb.BaseMessage, arm: str, what: str):
    if msg.WhichOneof("message") != arm:
        raise ValueError(f"message does not contain a {what}")
    return getattr(msg, arm)


def _timestamp(ns: int) -> pb.Timestamp:
    ts = pb.Timestamp()
    ts.FromNanoseconds(ns)
    return ts


def create_generate_request(
    model: str,
    prompt: str = "",
    stream: bool = False,
    messages: Iterable[Mapping[str, str]] = (),
    max_tokens: int = 0,
    temperature: float = 0.0,
    top_p: float = 0.0,
    seed: int = 0,
    stop: Iterable[str] = (),
    top_k: int = 0,
    repeat_penalty: float = 0.0,
) -> pb.BaseMessage:
    req = pb.GenerateRequest(
        model=model, prompt=prompt, stream=stream, max_tokens=max_tokens,
        temperature=temperature, top_p=top_p, seed=seed, top_k=top_k,
        repeat_penalty=repeat_penalty,
        stop=[str(s) for s in stop],
        messages=[pb.ChatMessage(role=m.get("role", "user"),
                                 content=m.get("content", ""))
                  for m in messages])
    return pb.BaseMessage(generate_request=req)


def _generate_response(model: str, response: str, worker_id: str,
                       done: bool, done_reason: str, total_duration_ns: int,
                       prompt_tokens: int, completion_tokens: int,
                       created_ns: int) -> pb.GenerateResponse:
    return pb.GenerateResponse(
        model=model, created_at=_timestamp(created_ns), response=response,
        done=done, done_reason=done_reason if done else "",
        worker_id=worker_id, total_duration=total_duration_ns,
        prompt_tokens=prompt_tokens, completion_tokens=completion_tokens)


def create_generate_response(
    model: str,
    response: str,
    worker_id: str = "",
    done: bool = True,
    done_reason: str = "stop",
    total_duration_ns: int = 0,
    prompt_tokens: int = 0,
    completion_tokens: int = 0,
) -> pb.BaseMessage:
    return resp_msg(_generate_response(
        model, response, worker_id, done, done_reason, total_duration_ns,
        prompt_tokens, completion_tokens, time.time_ns()))


def resp_msg(resp: pb.GenerateResponse) -> pb.BaseMessage:
    return pb.BaseMessage(generate_response=resp)


def genresp_frame_bytes(
    model: str,
    response: str,
    worker_id: str = "",
    done: bool = True,
    done_reason: str = "stop",
    total_duration_ns: int = 0,
    prompt_tokens: int = 0,
    completion_tokens: int = 0,
    trace_id: str = "",
    parent_span: str = "",
    created_ns: int | None = None,
) -> bytes:
    """Encoded wire frame ([4B BE len][BaseMessage]) of a GenerateResponse
    envelope built from scalars: the per-chunk path of a streaming worker.
    The same bytes as the JAX package's for the same ``created_ns``.  The
    native encoder serves while the library is loaded (see ``wire``'s
    envelope fast path); both paths give the same bytes."""
    if created_ns is None:
        created_ns = time.time_ns()
    frame = wire.encode_genresp_frame(
        model=model, response=response, worker_id=worker_id, done=done,
        done_reason=done_reason, total_duration_ns=total_duration_ns,
        prompt_tokens=prompt_tokens, completion_tokens=completion_tokens,
        created_ns=created_ns, trace_id=trace_id, parent_span=parent_span)
    if frame is not None:
        return frame
    msg = resp_msg(_generate_response(
        model, response, worker_id, done, done_reason, total_duration_ns,
        prompt_tokens, completion_tokens, created_ns))
    msg.trace_id = trace_id
    msg.parent_span = parent_span
    return wire.encode_frame(msg)


def extract_generate_request(msg: pb.BaseMessage) -> pb.GenerateRequest:
    return _extract(msg, "generate_request", "GenerateRequest")


def extract_generate_response(msg: pb.BaseMessage) -> pb.GenerateResponse:
    return _extract(msg, "generate_response", "GenerateResponse")


def create_embed_request(model: str, inputs: Iterable[str],
                         truncate: bool = True) -> pb.BaseMessage:
    return pb.BaseMessage(embed_request=pb.EmbedRequest(
        model=model, input=list(inputs), truncate=truncate))


def create_embed_response(
    model: str,
    embeddings: Iterable[Iterable[float]],
    worker_id: str = "",
    total_duration_ns: int = 0,
    prompt_tokens: int = 0,
    error: str = "",
) -> pb.BaseMessage:
    return pb.BaseMessage(embed_response=pb.EmbedResponse(
        model=model, worker_id=worker_id, total_duration=total_duration_ns,
        prompt_tokens=prompt_tokens, error=error,
        embeddings=[pb.Embedding(values=list(vec)) for vec in embeddings]))


def extract_embed_request(msg: pb.BaseMessage) -> pb.EmbedRequest:
    return _extract(msg, "embed_request", "EmbedRequest")


def extract_embed_response(msg: pb.BaseMessage) -> pb.EmbedResponse:
    return _extract(msg, "embed_response", "EmbedResponse")


def create_kv_fetch_request(model: str, chain_hashes: Iterable[bytes],
                            page_size: int) -> pb.BaseMessage:
    return pb.BaseMessage(kv_fetch_request=pb.KvFetchRequest(
        model=model, page_size=int(page_size),
        chain_hashes=[bytes(h) for h in chain_hashes]))


def extract_kv_fetch_request(msg: pb.BaseMessage) -> pb.KvFetchRequest:
    return _extract(msg, "kv_fetch_request", "KvFetchRequest")


def kv_pages_msg(pages: pb.KvPages) -> pb.BaseMessage:
    return pb.BaseMessage(kv_pages=pages)


def extract_kv_pages(msg: pb.BaseMessage) -> pb.KvPages:
    return _extract(msg, "kv_pages", "KvPages")


def migrate_frame_msg(
    model: str,
    worker_id: str,
    delivered_tokens: int = 0,
    prompt_tokens: int = 0,
    chain_hashes: Iterable[bytes] = (),
    page_size: int = 0,
    reason: str = "drain",
) -> pb.BaseMessage:
    return pb.BaseMessage(migrate_frame=pb.MigrateFrame(
        model=model, worker_id=worker_id,
        delivered_tokens=int(delivered_tokens),
        prompt_tokens=int(prompt_tokens), page_size=int(page_size),
        reason=reason, chain_hashes=[bytes(h) for h in chain_hashes]))


def extract_migrate_frame(msg: pb.BaseMessage) -> pb.MigrateFrame:
    return _extract(msg, "migrate_frame", "MigrateFrame")


def gossip_frame_msg(
    origin: str,
    entries: Iterable[Mapping] = (),
    usage: Iterable[Mapping] = (),
    sync: bool = False,
    clock: int = 0,
) -> pb.BaseMessage:
    """One replicated-gateway anti-entropy frame; ``entries``/``usage`` are
    mappings with the GossipEntry / TenantUsage field names."""
    fr = pb.GossipFrame(origin=origin, sync=bool(sync), clock=int(clock))
    for e in entries:
        fr.entries.add(
            key=str(e["key"]), value=str(e.get("value", "")),
            version=int(e.get("version", 0)),
            tombstone=bool(e.get("tombstone", False)),
            origin=str(e.get("origin", "")))
    for u in usage:
        fr.usage.add(
            origin=str(u["origin"]), tenant=str(u["tenant"]),
            admitted=int(u.get("admitted", 0)),
            version=int(u.get("version", 0)))
    return pb.BaseMessage(gossip_frame=fr)


def extract_gossip_frame(msg: pb.BaseMessage) -> pb.GossipFrame:
    return _extract(msg, "gossip_frame", "GossipFrame")


def trace_fetch_msg(trace_id: str) -> pb.BaseMessage:
    """Collector -> node: "send me your span fragment for this trace"."""
    return pb.BaseMessage(trace_fetch=pb.TraceFetch(trace_id=trace_id))


def extract_trace_fetch(msg: pb.BaseMessage) -> pb.TraceFetch:
    return _extract(msg, "trace_fetch", "TraceFetch")


def trace_spans_msg(trace_id: str, node: str = "", payload: bytes = b"",
                    found: bool = False, error: str = "") -> pb.BaseMessage:
    """Node -> collector: one span fragment (payload = JSON trace
    record)."""
    return pb.BaseMessage(trace_spans=pb.TraceSpans(
        trace_id=trace_id, node=node, payload=bytes(payload),
        found=bool(found), error=error))


def extract_trace_spans(msg: pb.BaseMessage) -> pb.TraceSpans:
    return _extract(msg, "trace_spans", "TraceSpans")


def metrics_fetch_msg(families: Iterable[str] = ()) -> pb.BaseMessage:
    """Gateway -> worker: "send me your metric exposition" (optionally
    only families with one of the given name prefixes)."""
    return pb.BaseMessage(metrics_fetch=pb.MetricsFetch(
        families=[str(f) for f in families]))


def extract_metrics_fetch(msg: pb.BaseMessage) -> pb.MetricsFetch:
    return _extract(msg, "metrics_fetch", "MetricsFetch")


def metrics_snapshot_msg(node: str = "", payload: bytes = b"",
                         found: bool = False,
                         error: str = "") -> pb.BaseMessage:
    """Worker -> gateway: one scrape (payload = Prometheus exposition
    text)."""
    return pb.BaseMessage(metrics_snapshot=pb.MetricsSnapshot(
        node=node, payload=bytes(payload), found=bool(found), error=error))


def extract_metrics_snapshot(msg: pb.BaseMessage) -> pb.MetricsSnapshot:
    return _extract(msg, "metrics_snapshot", "MetricsSnapshot")


def draft_chunk_msg(model: str = "", chunk_id: int = 0, position: int = 0,
                    tokens: Iterable[int] = ()) -> pb.BaseMessage:
    """Client -> worker: one chunk of drafted tokens starting at absolute
    ``position``; an empty tokens list is a pure pipeline credit."""
    return pb.BaseMessage(draft_chunk=pb.DraftChunk(
        model=model, chunk_id=int(chunk_id), position=int(position),
        tokens=[int(t) for t in tokens]))


def extract_draft_chunk(msg: pb.BaseMessage) -> pb.DraftChunk:
    return _extract(msg, "draft_chunk", "DraftChunk")


def verify_result_msg(chunk_id: int = 0, position: int = 0,
                      accepted: int = 0, tokens: Iterable[int] = (),
                      done: bool = False, draft_k: int = 0,
                      depth_hint: int = 0,
                      prompt_ids: Iterable[int] = ()) -> pb.BaseMessage:
    """Worker -> client: one verify round's outcome (chunk_id 0 = the
    stream handshake carrying prompt_ids and the first emitted token)."""
    return pb.BaseMessage(verify_result=pb.VerifyResult(
        chunk_id=int(chunk_id), position=int(position),
        accepted=int(accepted), done=bool(done), draft_k=int(draft_k),
        depth_hint=int(depth_hint), tokens=[int(t) for t in tokens],
        prompt_ids=[int(t) for t in prompt_ids]))


def extract_verify_result(msg: pb.BaseMessage) -> pb.VerifyResult:
    return _extract(msg, "verify_result", "VerifyResult")


def flatten_chat(messages: Iterable[Mapping[str, str]]) -> str:
    """Ollama-style chat messages flattened into one role-tagged prompt
    string (the fallback of engines without a chat template)."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    parts.append("assistant:")
    return "\n".join(parts)
