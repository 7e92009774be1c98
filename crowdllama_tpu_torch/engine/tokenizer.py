"""The dependency-free byte tokenizer and its stream decoder.

Counterpart of ``crowdllama_tpu/engine/tokenizer.py`` (byte path only):
ids 0-255 are raw bytes, then PAD/BOS/EOS.  Streaming decode is
incremental and UTF-8-safe (partial multibyte sequences are held back).
"""

from __future__ import annotations

import codecs


class ByteStreamDecoder:
    """Incremental detokenizer: feed ids, get printable text deltas."""

    def __init__(self, tok: "ByteTokenizer"):
        self._decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        self._specials = {tok.pad_id, tok.bos_id, tok.eos_id}

    def feed(self, token_id: int) -> str:
        if token_id in self._specials or token_id > 255:
            return ""
        return self._decoder.decode(bytes([token_id]))


class ByteTokenizer:
    """Bytes + specials; works with any model vocab >= 259."""

    PAD, BOS, EOS = 256, 257, 258

    def __init__(self):
        self.pad_id = self.PAD
        self.bos_id = self.BOS
        self.eos_id = self.EOS
        self.vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i <= 255)
        return data.decode("utf-8", errors="replace")

    def stream_decoder(self) -> ByteStreamDecoder:
        return ByteStreamDecoder(self)


def get_tokenizer(model_path: str = "") -> ByteTokenizer:
    """The byte tokenizer; checkpoint tokenizers are not ported yet."""
    if model_path:
        raise NotImplementedError(
            "checkpoint tokenizers are not ported yet (model_path="
            f"{model_path!r}); serve random-init weights with the byte "
            "tokenizer")
    return ByteTokenizer()
