"""HF checkpoint directories made without downloading anything.

What a smoke run or a test needs to serve an HF directory when no
checkpoint can be fetched: the chat templates of the registry's families
as their checkpoints publish them, the published ``config.json`` fields
of TinyLlama-1.1B-Chat and Llama-3.1-8B-Instruct, and two synthetic
``tokenizer.json`` files of the families' kinds at a model's full vocab
size:

- :func:`sentencepiece_tokenizer`: TinyLlama's byte-fallback BPE (the
  ``Prepend`` + ``Replace`` normalizer, no pre-tokenizer, ``<0xXX>`` byte
  tokens at ids 3-258) under ``LlamaTokenizer``;
- :func:`byte_level_tokenizer`: Llama-3's byte-level BPE (its ``Split``
  pattern, ``ignore_merges``, the 256 special tokens from id 128000)
  under ``PreTrainedTokenizerFast``.

Each learns a few merges from a corpus with :func:`train_merges` and
fills the rest of the vocab with filler words, so every id a model can
emit decodes to text.  :func:`write_tokenizer` writes ``tokenizer.json``
and ``tokenizer_config.json`` into a directory.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from crowdllama_tpu_torch.engine.tokenizer_json import BYTE_CHAR, _compile

TINYLLAMA_CHAT = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")

LLAMA31_CHAT = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message + builtin tools #}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\\n\\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\\n\\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
                {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- '{"name": "' + tool_call.name + '", ' }}
            {{- '"parameters": ' }}
            {{- tool_call.arguments | tojson }}
            {{- "}" }}
        {%- endif %}
        {%- if builtin_tools is defined %}
            {#- This means we're in ipython mode #}
            {{- "<|eom_id|>" }}
        {%- else %}
            {{- "<|eot_id|>" }}
        {%- endif %}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

# config.json as the checkpoints publish it.
TINYLLAMA_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 5632, "max_position_embeddings": 2048,
    "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 22, "num_key_value_heads": 4, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 32000}
LLAMA31_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": [128001, 128008, 128009], "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 131072,
    "mlp_bias": False, "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256}

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|"
                r"\s+")
SP_SPECIALS = ("<unk>", "<s>", "</s>")
# Llama-3's 256 special tokens from id 128000.
LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>",
                    "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>",
                    "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>",
                    "<|python_tag|>"]
                   + [f"<|reserved_special_token_{k}|>"
                      for k in range(3, 248)])


def train_merges(words: list[str], n: int) -> list[tuple[str, str]]:
    """``n`` BPE merges learned from ``words`` (the most frequent adjacent
    pair first, ties to the smaller pair)."""
    counts = Counter(tuple(w) for w in words)
    merges: list[tuple[str, str]] = []
    for _ in range(n):
        pairs: Counter = Counter()
        for w, c in counts.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged: Counter = Counter()
        for w, c in counts.items():
            out, k = [], 0
            while k < len(w):
                if k + 1 < len(w) and (w[k], w[k + 1]) == best:
                    out.append(w[k] + w[k + 1])
                    k += 2
                else:
                    out.append(w[k])
                    k += 1
            merged[tuple(out)] += c
        counts = merged
    return merges


def _vocab(head: list[str], words: list[str], merges, size: int,
           filler: str) -> dict[str, int]:
    vocab: dict[str, int] = {}
    for tok in head + sorted({ch for w in words for ch in w}) + [
            a + b for a, b in merges]:
        vocab.setdefault(tok, len(vocab))
    k = 0
    while len(vocab) < size:
        vocab.setdefault(f"{filler}{k}", len(vocab))
        k += 1
    return vocab


def _added(tokens, first_id: int) -> list[dict]:
    return [{"id": first_id + i, "content": t, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False,
             "special": True} for i, t in enumerate(tokens)]


def sentencepiece_tokenizer(corpus: list[str], vocab_size: int = 32000,
                            n_merges: int = 64) -> tuple[dict, dict]:
    """(tokenizer.json, tokenizer_config.json) of TinyLlama's kind."""
    words = []
    for text in corpus:
        norm = "▁" + text.replace(" ", "▁")
        words += ["▁" + w for w in norm.split("▁") if w]
    merges = train_merges(words, n_merges)
    head = list(SP_SPECIALS) + [f"<0x{b:02X}>" for b in range(256)]
    vocab = _vocab(head, words, merges, vocab_size, "▁w")
    doc = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(SP_SPECIALS, 0),
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                       "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"},
             "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]}}
    config = {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>",
              "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "</s>",
              "add_bos_token": True, "add_eos_token": False, "legacy": False,
              "clean_up_tokenization_spaces": False,
              "model_max_length": 2048, "chat_template": TINYLLAMA_CHAT}
    return doc, config


def byte_level_tokenizer(corpus: list[str], vocab_size: int = 128256,
                         n_merges: int = 64) -> tuple[dict, dict]:
    """(tokenizer.json, tokenizer_config.json) of Llama-3's kind."""
    split = _compile(LLAMA3_SPLIT)
    words = ["".join(BYTE_CHAR[b] for b in m.group().encode("utf-8"))
             for text in corpus for m in split.finditer(text)]
    merges = train_merges(words, n_merges)
    n_special = len(LLAMA3_SPECIALS)
    head = [BYTE_CHAR[b] for b in range(256)]
    vocab = _vocab(head, words, merges, vocab_size - n_special,
                   "Ġtok")
    first = len(vocab)
    doc = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(LLAMA3_SPECIALS, first),
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": "<|begin_of_text|>",
                                          "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": "<|begin_of_text|>",
                                        "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": "<|begin_of_text|>",
                                        "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {"<|begin_of_text|>": {
                 "id": "<|begin_of_text|>", "ids": [first],
                 "tokens": ["<|begin_of_text|>"]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in merges]}}
    config = {"tokenizer_class": "PreTrainedTokenizerFast",
              "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
              "clean_up_tokenization_spaces": True,
              "model_max_length": 131072, "chat_template": LLAMA31_CHAT}
    return doc, config


def write_tokenizer(path: str | Path, doc: dict, config: dict) -> None:
    """``tokenizer.json`` and ``tokenizer_config.json`` into ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(doc, ensure_ascii=False),
                                         encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps(config, indent=2),
                                                encoding="utf-8")
