"""Tokenizers: the dependency-free byte tokenizer and a checkpoint's own.

Counterpart of ``crowdllama_tpu/engine/tokenizer.py``.  The byte
tokenizer serves random weights: ids 0-255 are raw bytes, then
PAD/BOS/EOS.  :class:`HFTokenizer` serves a checkpoint directory's
``tokenizer.json`` through the port's own reader
(``engine/tokenizer_json.py``) with what ``transformers`` adds on top
(``tokenizer_config.json``'s special tokens, the post-processor a Llama
or Gemma ``tokenizer_class`` rebuilds from ``add_bos_token`` /
``add_eos_token``, ``clean_up_tokenization_spaces``) and renders its chat
template (``engine/chat_template.py``).  Streaming decode is incremental
and UTF-8-safe (partial multibyte sequences are held back).
"""

from __future__ import annotations

import codecs
import json
import logging
from pathlib import Path

log = logging.getLogger("crowdllama.torch.engine.tokenizer")


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


# tokenizer_class -> (its special-token defaults, whether it rebuilds the
# post-processor from add_bos_token / add_eos_token), as transformers'
# fast classes of those names.
_CLASSES = {
    "PreTrainedTokenizerFast": ({}, False),
    "LlamaTokenizerFast": ({"unk_token": "<unk>", "bos_token": "<s>",
                            "eos_token": "</s>"}, True),
    "GemmaTokenizerFast": ({"unk_token": "<unk>", "bos_token": "<bos>",
                            "eos_token": "<eos>", "pad_token": "<pad>"},
                           True),
    "Qwen2TokenizerFast": ({"unk_token": "<|endoftext|>",
                            "eos_token": "<|endoftext|>",
                            "pad_token": "<|endoftext|>"}, False),
}
# config.json model_type -> tokenizer_class, where tokenizer_config.json
# names none (AutoTokenizer's mapping for the families the port serves).
_MODEL_TYPES = {"llama": "LlamaTokenizerFast", "mistral": "LlamaTokenizerFast",
                "mixtral": "LlamaTokenizerFast", "gemma": "GemmaTokenizerFast",
                "gemma2": "GemmaTokenizerFast", "qwen2": "Qwen2TokenizerFast",
                "qwen3": "Qwen2TokenizerFast"}
_SPECIALS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
             "cls_token", "mask_token")


def _content(value) -> str | None:
    return value.get("content") if isinstance(value, dict) else value


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8")) if path.exists() \
        else {}


def _clean_up_tokenization(text: str) -> str:
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
                 (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFTokenizer:
    """A checkpoint directory's ``tokenizer.json`` and
    ``tokenizer_config.json``, read as ``AutoTokenizer`` reads them."""

    def __init__(self, path: str):
        from crowdllama_tpu_torch.engine import chat_template
        from crowdllama_tpu_torch.engine.tokenizer_json import TokenizerJSON

        root = Path(path).expanduser()
        self._tok = TokenizerJSON.from_file(root / "tokenizer.json")
        tc = _read_json(root / "tokenizer_config.json")
        cls = tc.get("tokenizer_class")
        if not cls:
            model_type = _read_json(root / "config.json").get("model_type")
            cls = _MODEL_TYPES.get(model_type)
            if cls is None:
                raise ValueError(f"{root}: no tokenizer_class and no "
                                 f"known model_type ({model_type!r})")
        if not cls.endswith("Fast"):
            cls += "Fast"
        if cls not in _CLASSES:
            raise ValueError(f"tokenizer_class {cls!r} is not read by "
                             f"this package (known: {sorted(_CLASSES)})")
        defaults, rebuilds = _CLASSES[cls]
        if rebuilds and tc.get("add_prefix_space") is not None:
            raise ValueError(f"{cls} with add_prefix_space set converts "
                             f"from the slow tokenizer, which this package "
                             f"does not read")
        init = {**defaults, **tc}
        if "added_tokens_decoder" not in tc:
            # Files older than added_tokens_decoder: special_tokens_map.json
            # supplies the special tokens.
            init.update(_read_json(root / "special_tokens_map.json"))
        for _, spec in sorted((tc.get("added_tokens_decoder") or {}).items(),
                              key=lambda kv: int(kv[0])):
            if self._tok.token_to_id(spec["content"]) is None:
                self._tok.add_token(spec["content"],
                                    bool(spec.get("special")))
        self.special_tokens = {k: _content(init[k]) for k in _SPECIALS
                               if _content(init.get(k)) is not None}
        extra = [_content(t) for t in
                 init.get("additional_special_tokens") or []]
        for tok in [*self.special_tokens.values(), *extra]:
            if tok:
                self._tok.add_token(tok, True)
        # transformers sets a top-level pre-tokenizer's add_prefix_space
        # to tokenizer_config.json's (False when absent).
        pre = self._tok.pre_tokenizer_spec
        want = bool(init.get("add_prefix_space", False))
        if (not rebuilds and isinstance(pre, dict)
                and "add_prefix_space" in pre
                and bool(pre["add_prefix_space"]) != want):
            self._tok.set_pre_tokenizer(dict(pre, add_prefix_space=want))
        unk = self.special_tokens.get("unk_token")
        unk_id = self._tok.token_to_id(unk) if unk is not None else None

        def tid(name: str) -> int | None:
            tok = self.special_tokens.get(name)
            if tok is None:
                return None
            got = self._tok.token_to_id(tok)
            return got if got is not None else unk_id

        bos, eos, pad = tid("bos_token"), tid("eos_token"), tid("pad_token")
        if rebuilds:
            add_bos = bool(init.get("add_bos_token", True))
            add_eos = bool(init.get("add_eos_token", False))
            single: list = []
            named: dict = {}
            for on, key, ident in ((add_bos, "bos_token", bos),
                                   (add_eos, "eos_token", eos)):
                if not on:
                    continue
                tok = self.special_tokens.get(key)
                if tok is None:
                    raise ValueError(f"add_{key[:3]}_token = True but "
                                     f"{key} = None")
                named[tok] = {"id": tok, "ids": [ident], "tokens": [tok]}
            if add_bos:
                single.append({"SpecialToken": {
                    "id": self.special_tokens["bos_token"], "type_id": 0}})
            single.append({"Sequence": {"id": "A", "type_id": 0}})
            if add_eos:
                single.append({"SpecialToken": {
                    "id": self.special_tokens["eos_token"], "type_id": 0}})
            self._tok.set_template(single, named)
        # `x if x is not None`: 0 is a legitimate id for any of these.
        self.bos_id = bos if bos is not None else -1
        self.eos_id = eos if eos is not None else -1
        self.pad_id = pad if pad is not None else self.eos_id
        self.clean_up = bool(init.get("clean_up_tokenization_spaces", False))
        self.chat_template = chat_template.load_template(root, tc)
        # The special tokens a template sees (transformers'
        # special_tokens_map).
        self._template_tokens = dict(self.special_tokens)
        if extra:
            self._template_tokens["additional_special_tokens"] = extra

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids: list[int]) -> str:
        text = self._tok.decode(ids, skip_special_tokens=True)
        return _clean_up_tokenization(text) if self.clean_up else text

    def stream_decoder(self) -> "_HFStreamDecoder":
        return _HFStreamDecoder(self)

    def token_text(self, token_id: int) -> str:
        """The raw vocab string of one id (sentencepiece '▁' / byte-level
        'Ġ' markers intact), "" for an id outside the vocab."""
        return self._tok.id_to_token(int(token_id)) or ""

    def format_chat(self, messages: list[dict]) -> str:
        """The chat rendered by the checkpoint's own template, with the
        generation prompt.  Raises ValueError when there is no template
        (or none this package renders): callers flatten the chat."""
        if self.chat_template is None:
            raise ValueError("tokenizer has no chat template")
        return self.chat_template.render(
            messages=[dict(m) for m in messages], tools=None, documents=None,
            add_generation_prompt=True, **self._template_tokens)


class _HFStreamDecoder:
    """Incremental detokenizer over a pending-id window: the ids not yet
    emitted are decoded each step, and the window flushes once its text
    does not end in U+FFFD.  A window's first token that starts a word
    (a leading '▁' or 'Ġ') gets back the space a windowed decode drops."""

    def __init__(self, tok: HFTokenizer):
        self._tok = tok
        self._pending: list[int] = []
        self._first = True

    def feed(self, token_id: int) -> str:
        self._pending.append(token_id)
        text = self._tok.decode(self._pending)
        if text.endswith("\ufffd"):  # mid-multibyte; wait for more ids
            return ""
        lead = self._tok.token_text(self._pending[0])
        if (not self._first and lead and lead[0] in ("\u2581", "\u0120")
                and not text.startswith(" ")):
            text = " " + text
        self._pending.clear()
        if text:
            self._first = False
        return text


def get_tokenizer(model_path: str = ""):
    """The checkpoint's tokenizer at ``model_path``; without a path, or
    when it cannot be read (with a warning), the byte tokenizer."""
    if model_path:
        try:
            return HFTokenizer(model_path)
        except Exception as e:
            log.warning("no usable tokenizer at %s (%s); falling back to "
                        "byte tokenizer: WRONG for real checkpoints",
                        model_path, e)
    return ByteTokenizer()
