"""The port's tokenizer.json reader against the JAX package's HFTokenizer.

The JAX package wraps ``transformers.AutoTokenizer``; the port reads the
same files with its own code (``engine/tokenizer_json.py``,
``engine/tokenizer.py HFTokenizer``).  Tokenizers are trained here with
``tokenizers`` on a fixed corpus, one of each family's kind, and saved with
``PreTrainedTokenizerFast.save_pretrained`` into ``tmp_path``:

- SentencePiece-style byte-fallback BPE: TinyLlama's normalizer
  (``Prepend`` + ``Replace``) under ``LlamaTokenizer``, Mistral's newer
  ``Metaspace`` pre-tokenizer, and Gemma's (``Replace`` alone, no prefix)
  under ``GemmaTokenizer``;
- byte-level BPE with Llama-3's ``Split`` pattern and ``ignore_merges``
  under ``PreTrainedTokenizerFast`` (``clean_up_tokenization_spaces``);
- Qwen's ``NFC`` + ``Split`` under ``Qwen2Tokenizer``;

each with and without ``tokenizer_class`` (without it, ``config.json``'s
``model_type`` names the class), and one file in the older form (merges as
``"a b"`` strings, the chat template inside ``tokenizer_config.json``).
The two must agree on the three ids, ``encode`` of the corpus and of
hypothesis text (many scripts, digits, runs of spaces and ``\\r\\n``,
U+001C-U+001F, apostrophes, emoji, added tokens inside words), ``decode``
and the stream decoder's deltas on hypothesis id sequences (specials, ids
past the vocab, cut UTF-8), and ``token_text``.
"""

import json
import shutil

import pytest

pytest.importorskip("torch")
tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from crowdllama_tpu.engine.tokenizer import HFTokenizer as JaxHF  # noqa: E402
from crowdllama_tpu_torch.engine import tokenizer as ttok  # noqa: E402
from crowdllama_tpu_torch.engine import tokenizer_json as tj  # noqa: E402
from crowdllama_tpu_torch.engine.unicode_overlay import (  # noqa: E402
    CHANGED,
    UNICODE_VERSION,
)

CORPUS = """The quick brown fox jumps over the lazy dog. It's 2024; we'll see.
Hello, world! I'm here and you're there; they've gone, she'd said.
Numbers: 0 1 12 123 1234 12345 3.14159 -42 +7 1e10 ٣٤٥ ⅷ
Über café naïve façade résumé déjà vu — “quotes” and ‘single’ ones…
Привет, мир! Как дела? Ελληνικά γράμματα. עברית ערבית العربية
日本語のテキストと漢字。中文文本，还有标点。한국어 텍스트입니다.
हिन्दी पाठ। ภาษาไทย ქართული Հայերեն emoji 🙂🚀👍🏽 and 👨‍👩‍👧 family
tabs\tand  double  spaces   triple\r\nwindows lines\n\nblank lines
code: def f(x): return x**2 # comment {braces} [brackets] <angle>
""" * 3

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|"
                r"\s+")
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

TINYLLAMA_CHAT = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")


def _byte_fallback_bpe(trainer_vocab: int, normalizer, pre_tokenizer,
                       decoder, specials: list[str]):
    """A SentencePiece-style BPE: the specials, the 256 ``<0xXX>`` byte
    tokens, then what a trainer learns on the corpus (as Llama's vocab
    orders them)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    base = Tokenizer(models.BPE())
    base.normalizer = normalizer
    base.pre_tokenizer = pre_tokenizer or pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="first", split=True)
    base.train_from_iterator(CORPUS.splitlines(), trainers.BpeTrainer(
        vocab_size=trainer_vocab, show_progress=False, special_tokens=[]))
    learned = json.loads(base.to_str())["model"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for tok in sorted(learned["vocab"], key=learned["vocab"].get):
        vocab.setdefault(tok, len(vocab))
    doc = json.loads(Tokenizer(models.BPE()).to_str())
    doc["model"] = {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                    "continuing_subword_prefix": None,
                    "end_of_word_suffix": None, "fuse_unk": True,
                    "byte_fallback": True, "ignore_merges": False,
                    "vocab": vocab, "merges": learned["merges"]}
    doc["added_tokens"] = [
        {"id": i, "content": t, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, t in enumerate(specials)]
    tok = Tokenizer.from_str(json.dumps(doc))
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizer
    tok.decoder = decoder
    return tok


def _byte_level_bpe(vocab_size: int, split: str, normalizer, specials,
                    ignore_merges: bool):
    from tokenizers import Regex, Tokenizer, decoders, models
    from tokenizers import pre_tokenizers as pt
    from tokenizers import trainers

    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    tok.normalizer = normalizer
    tok.pre_tokenizer = pt.Sequence([
        pt.Split(Regex(split), behavior="isolated", invert=False),
        pt.ByteLevel(add_prefix_space=False, trim_offsets=True,
                     use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS.splitlines(keepends=True),
                            trainers.BpeTrainer(
                                vocab_size=vocab_size, show_progress=False,
                                special_tokens=specials,
                                initial_alphabet=pt.ByteLevel.alphabet()))
    return tok


def build_family(family: str):
    """(tokenizers.Tokenizer, tokenizer_config kwargs, config.json
    model_type) of one family's kind."""
    from tokenizers import decoders, normalizers, processors

    sp_decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    if family == "tinyllama":
        tok = _byte_fallback_bpe(
            400, normalizers.Sequence([normalizers.Prepend("▁"),
                                       normalizers.Replace(" ", "▁")]),
            None, sp_decoder, ["<unk>", "<s>", "</s>"])
        tok.add_tokens(["<|user|>", "<|assistant|>", "<|system|>"])
        return tok, dict(tokenizer_class="LlamaTokenizer",
                         chat_template=TINYLLAMA_CHAT), "llama"
    if family == "mistral":
        from tokenizers import pre_tokenizers as pt

        tok = _byte_fallback_bpe(
            400, None, pt.Metaspace(replacement="▁", prepend_scheme="first",
                                    split=False),
            sp_decoder, ["<unk>", "<s>", "</s>"])
        tok.add_special_tokens(["[INST]", "[/INST]"])
        return tok, dict(tokenizer_class="LlamaTokenizer"), "mistral"
    if family == "gemma":
        tok = _byte_fallback_bpe(
            400, normalizers.Replace(" ", "▁"), None,
            decoders.Sequence([decoders.Replace("▁", " "),
                               decoders.ByteFallback(), decoders.Fuse()]),
            ["<pad>", "<eos>", "<bos>", "<unk>"])
        tok.add_special_tokens(["<start_of_turn>", "<end_of_turn>"])
        return tok, dict(tokenizer_class="GemmaTokenizer"), "gemma2"
    if family == "llama3":
        specials = ["<|begin_of_text|>", "<|end_of_text|>",
                    "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]
        tok = _byte_level_bpe(700, LLAMA3_SPLIT, None, specials, True)
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(
                single="<|begin_of_text|> $A",
                pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                special_tokens=[("<|begin_of_text|>", 0)])])
        return tok, dict(tokenizer_class="PreTrainedTokenizerFast",
                         bos_token="<|begin_of_text|>",
                         eos_token="<|eot_id|>",
                         clean_up_tokenization_spaces=True), "llama"
    if family == "qwen":
        specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
        tok = _byte_level_bpe(700, QWEN_SPLIT, normalizers.NFC(), specials,
                              False)
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
        return tok, dict(tokenizer_class="Qwen2Tokenizer", bos_token=None,
                         eos_token="<|im_end|>", pad_token="<|endoftext|>"), \
            "qwen2"
    raise ValueError(family)


def save_family(family: str, path, with_class: bool = True,
                old_form: bool = False):
    """Save one family's tokenizer into ``path`` as ``save_pretrained``
    writes it (plus a ``config.json`` naming its ``model_type``)."""
    from transformers import PreTrainedTokenizerFast

    tok, kw, model_type = build_family(family)
    kw = dict(kw)
    kw.setdefault("bos_token", {"tinyllama": "<s>", "mistral": "<s>",
                                "gemma": "<bos>"}.get(family))
    kw.setdefault("eos_token", {"tinyllama": "</s>", "mistral": "</s>",
                                "gemma": "<eos>"}.get(family))
    if family in ("tinyllama", "mistral", "gemma"):
        kw.setdefault("unk_token", "<unk>")
    if family == "gemma":
        kw.setdefault("pad_token", "<pad>")
    cls = kw.pop("tokenizer_class")
    template = kw.pop("chat_template", None)
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, **{
        k: v for k, v in kw.items() if v is not None})
    if template:
        fast.chat_template = template
    path.mkdir(parents=True, exist_ok=True)
    fast.save_pretrained(str(path))
    (path / "config.json").write_text(json.dumps({"model_type": model_type}))
    cfg_file = path / "tokenizer_config.json"
    tc = json.loads(cfg_file.read_text())
    if with_class:
        tc["tokenizer_class"] = cls
    else:
        tc.pop("tokenizer_class", None)
    for k in ("bos_token", "eos_token", "pad_token", "unk_token"):
        if k in kw and kw[k] is None:
            tc[k] = None
    if old_form:
        doc = json.loads((path / "tokenizer.json").read_text())
        doc["model"]["merges"] = [" ".join(m) if isinstance(m, list) else m
                                  for m in doc["model"]["merges"]]
        (path / "tokenizer.json").write_text(json.dumps(doc))
        jinja = path / "chat_template.jinja"
        if jinja.exists():
            tc["chat_template"] = jinja.read_text()
            jinja.unlink()
    cfg_file.write_text(json.dumps(tc))
    return path


FAMILIES = ["tinyllama", "mistral", "gemma", "llama3", "qwen"]
CASES = [(f, True, False) for f in FAMILIES] + [
    (f, False, False) for f in FAMILIES] + [("tinyllama", True, True),
                                            ("llama3", True, True)]
CASE_IDS = [f"{f}-{'class' if c else 'noclass'}{'-old' if o else ''}"
            for f, c, o in CASES]
# The synthetic tokenizers the port writes itself where nothing can be
# downloaded (testing/hf_fixtures.py, what chip_smoke's hf phase serves),
# at a smaller vocab: read by transformers as by the port.
FIXTURES = {"fixture-sentencepiece": ("sentencepiece_tokenizer", 2000),
            "fixture-byte-level": ("byte_level_tokenizer", 4000)}
CASE_IDS += list(FIXTURES)


def save_fixture(case: str, path):
    from crowdllama_tpu_torch.testing import hf_fixtures

    make, vocab = FIXTURES[case]
    doc, config = getattr(hf_fixtures, make)(CORPUS.splitlines(),
                                             vocab_size=vocab)
    hf_fixtures.write_tokenizer(path, doc, config)
    return path


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(JAX HFTokenizer, port HFTokenizer) per case, built once."""
    out = {}
    for cid in CASE_IDS:
        path = tmp_path_factory.mktemp(cid)
        if cid in FIXTURES:
            save_fixture(cid, path)
        else:
            family, with_class, old = CASES[CASE_IDS.index(cid)]
            save_family(family, path, with_class, old)
        out[cid] = (JaxHF(str(path)), ttok.HFTokenizer(str(path)), path)
    return out


# Every character but the surrogates, unassigned ones too, and half the
# time one of those whose category changed after this Python's Unicode
# database (15.0 on 3.12), which ``tokenizers`` knows from its later tables
# and the port from ``engine/unicode_overlay.py`` (U+13460 among them).
_CHANGED = st.sampled_from(CHANGED).flatmap(
    lambda r: st.integers(r[0], r[1])).map(chr)
_ASSIGNED = st.one_of(st.characters(codec="utf-8", exclude_categories=("Cs",)),
                      _CHANGED)


_ADDED = ["<s>", "</s>", "<|user|>", "[INST]", "<|im_start|>",
          "<|eot_id|>", "<start_of_turn>", "<|begin_of_text|>"]
_TEXT = st.lists(st.one_of(
    st.text(alphabet=_ASSIGNED, max_size=12),
    st.sampled_from(["  ", "   ", "\r\n", "\n\n", "\t", " \n ", "\x1c",
                     "\x1d\x1e\x1f", "'s", "'LL", "n't", "’", "🙂", "👍🏽",
                     "1234567", "٣٤", "Ⅻ", "ſ", "é", "é", "ﬁ", "ǅ"]),
    st.sampled_from(CORPUS.split(" ")),
    st.sampled_from(_ADDED)), max_size=12).map("".join)


@pytest.mark.parametrize("case", CASE_IDS)
def test_ids_corpus_and_token_text_match(pairs, case):
    jax_tok, tok, _ = pairs[case]
    assert (tok.bos_id, tok.eos_id, tok.pad_id) == (
        jax_tok.bos_id, jax_tok.eos_id, jax_tok.pad_id)
    for line in CORPUS.splitlines(keepends=True)[:9]:
        assert tok.encode(line) == jax_tok.encode(line), line
    assert tok.encode(CORPUS) == jax_tok.encode(CORPUS)
    assert tok.encode("") == jax_tok.encode("")
    n = len(jax_tok._tok)
    for i in range(n + 3):
        assert tok.token_text(i) == jax_tok.token_text(i), i


@pytest.mark.parametrize("case", CASE_IDS)
@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_encode_matches_on_hypothesis_text(pairs, case, text):
    jax_tok, tok, _ = pairs[case]
    assert tok.encode(text) == jax_tok.encode(text)


def _ids(n: int):
    return st.lists(st.one_of(st.integers(0, n + 8),
                              st.integers(3, 258)), max_size=24)


@pytest.mark.parametrize("case", CASE_IDS)
@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_decode_and_stream_deltas_match(pairs, case, data):
    jax_tok, tok, _ = pairs[case]
    ids = data.draw(_ids(len(jax_tok._tok)))
    assert tok.decode(ids) == jax_tok.decode(ids)
    jdec, tdec = jax_tok.stream_decoder(), tok.stream_decoder()
    assert [tdec.feed(i) for i in ids] == [jdec.feed(i) for i in ids]


def test_unknown_components_raise_naming_them(tmp_path):
    path = save_family("qwen", tmp_path / "q")
    doc = json.loads((path / "tokenizer.json").read_text())
    doc["normalizer"] = {"type": "Lowercase"}
    with pytest.raises(tj.UnsupportedComponent, match="Lowercase"):
        tj.TokenizerJSON(doc)
    doc["normalizer"] = None
    doc["pre_tokenizer"] = {"type": "Whitespace"}
    with pytest.raises(tj.UnsupportedComponent, match="Whitespace"):
        tj.TokenizerJSON(doc)
    doc["pre_tokenizer"] = None
    doc["decoder"] = {"type": "WordPiece", "prefix": "##", "cleanup": True}
    with pytest.raises(tj.UnsupportedComponent, match="WordPiece"):
        tj.TokenizerJSON(doc)
    doc["decoder"] = None
    doc["model"] = {"type": "Unigram", "vocab": [["a", 0.0]]}
    with pytest.raises(tj.UnsupportedComponent, match="Unigram"):
        tj.TokenizerJSON(doc)


def test_unreadable_directory_falls_back_to_bytes_with_a_warning(
        tmp_path, caplog):
    path = save_family("qwen", tmp_path / "q")
    doc = json.loads((path / "tokenizer.json").read_text())
    doc["pre_tokenizer"] = {"type": "Whitespace"}
    (path / "tokenizer.json").write_text(json.dumps(doc))
    with caplog.at_level("WARNING"):
        tok = ttok.get_tokenizer(str(path))
    assert isinstance(tok, ttok.ByteTokenizer)
    assert "Whitespace" in caplog.text
    shutil.rmtree(path)
    assert isinstance(ttok.get_tokenizer(""), ttok.ByteTokenizer)


@settings(max_examples=50, deadline=None)
@given(text=st.text(alphabet=_ASSIGNED, max_size=40))
def test_split_patterns_match_the_oracle(text):
    """Llama-3's and Qwen's patterns (``\\p{L}``, ``\\p{N}``, ``\\s``,
    ``(?i:...)``) split as ``tokenizers`` splits them."""
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    for pattern in (LLAMA3_SPLIT, QWEN_SPLIT):
        want = [w for w, _ in pt.Split(Regex(pattern), "isolated")
                .pre_tokenize_str(text)]
        assert _pieces(pattern, text) == want


def _pieces(pattern: str, text: str) -> list[str]:
    ns = tj.NormalizedString.of(text)
    rx = tj._compile(pattern)
    return [p.text for p in tj._split(
        ns, [m.span() for m in rx.finditer(text)], "Isolated")]


# ------------------------------------------------- the Unicode overlay

def _changed_text() -> str:
    return "".join(chr(c) for a, b, _ in CHANGED for c in range(a, b + 1))


@pytest.mark.parametrize("cat", ["L", "N", "Lu", "Ll", "Lo", "Lm", "Mn",
                                 "Mc", "Nd", "No", "Po", "So", "Cn"])
def test_overlay_classes_match_the_oracle_on_changed_characters(cat):
    """``\\p{cat}`` over every code point whose category changed after
    Unicode 15.0: the port's class takes exactly what ``tokenizers``'
    takes."""
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    text = _changed_text()
    kept = set()
    for _, (a, b) in pt.Split(Regex(rf"\p{{{cat}}}"), "removed"
                              ).pre_tokenize_str(text):
        kept.update(range(a, b))
    want = {i for i in range(len(text)) if i not in kept}
    rx = tj._compile(rf"\p{{{cat}}}")
    assert {m.start() for m in rx.finditer(text)} == want


def test_overlay_ids_equal_jax_after_unicode_15(pairs):
    """Ids of text made of characters assigned after Unicode 15.0 (U+13460
    and every changed range's first and last) equal JAX's, which come
    through ``tokenizers``."""
    assert UNICODE_VERSION >= "16.0"
    chars = [chr(0x13460)] + [chr(c) for a, b, _ in CHANGED for c in (a, b)]
    texts = ["".join(chars), " ".join(chars), "x" + "".join(chars[:40]) + "7",
             "".join(chars[::-1]) + " 12"]
    for case in CASE_IDS:
        jax_tok, tok, _ = pairs[case]
        for text in texts:
            assert tok.encode(text) == jax_tok.encode(text), case
        for pattern in (LLAMA3_SPLIT, QWEN_SPLIT):
            from tokenizers import Regex
            from tokenizers import pre_tokenizers as pt

            for text in texts:
                want = [w for w, _ in pt.Split(Regex(pattern), "isolated")
                        .pre_tokenize_str(text)]
                assert _pieces(pattern, text) == want


def test_overlay_covers_every_character_assigned_after_unicode_15():
    """Every code point ``tokenizers`` assigns (outside ``\\p{Cn}``) that
    this Python's ``unicodedata`` leaves unassigned has its category in
    the overlay, and nothing ``tokenizers`` leaves unassigned is assigned
    by it (``tools/gen_unicode_overlay.py --check`` compares every
    category)."""
    import sys
    import unicodedata

    import numpy as np
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    cps = np.array([c for c in range(sys.maxunicode + 1)
                    if not 0xD800 <= c <= 0xDFFF])
    kept = np.zeros(len(cps), bool)
    for _, (a, b) in pt.Split(Regex(r"\p{Cn}"), "removed").pre_tokenize_str(
            "".join(map(chr, cps))):
        kept[a:b] = True
    oracle_cn = set(cps[~kept].tolist())
    overlay = {c: cat for a, b, cat in CHANGED for c in range(a, b + 1)}
    python_cn = {int(c) for c in cps if unicodedata.category(chr(c)) == "Cn"}
    newly = python_cn - oracle_cn
    assert 0x13460 in newly and len(newly) > 4000
    assert all(overlay.get(c, "Cn") != "Cn" for c in newly)

    def unassigned(c):  # this Python's category, overlaid
        return overlay.get(c, "Cn" if c in python_cn else "assigned") == "Cn"

    assert all(unassigned(c) for c in oracle_cn)
