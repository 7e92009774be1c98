"""A ``tokenizer.json`` reader: the ``tokenizers`` pipeline in plain Python.

The port's own counterpart of what ``tokenizers`` runs for a checkpoint's
``tokenizer.json`` (the card has neither ``tokenizers`` nor ``regex``).
Encoding goes, as there:

1. added tokens are cut out of the raw text, leftmost-longest, honouring
   ``lstrip`` / ``rstrip`` / ``single_word`` (those with
   ``normalized: true`` are cut out of the normalized pieces instead);
2. the normalizer runs on each remaining piece;
3. the pre-tokenizer splits the pieces into words;
4. the BPE model turns each word into ids;
5. the post-processor adds the special tokens of its template.

Decoding maps ids to tokens (ids known to neither the model nor the added
tokens are dropped; special added tokens too when asked), runs the
decoder chain and joins the result.

The components read: normalizers ``Sequence``, ``Prepend``, ``Replace``,
``NFC``, ``NFKC``; pre-tokenizers ``Sequence``, ``Split``, ``ByteLevel``,
``Metaspace``, ``Digits``; the ``BPE`` model (``byte_fallback``,
``fuse_unk``, ``unk_token``, ``ignore_merges``, merges as ``"a b"``
strings or ``[a, b]`` pairs); post-processors ``TemplateProcessing``,
``ByteLevel``, ``Sequence``; decoders ``Sequence``, ``Replace``,
``ByteFallback``, ``Fuse``, ``Strip``, ``ByteLevel``, ``Metaspace``.  Any
other component raises :class:`UnsupportedComponent` at load, naming it.

Patterns are Oniguruma's; Python's ``re`` lacks ``\\p{..}`` and its
``\\s`` also takes U+001C-U+001F, so :func:`onig_to_re` rewrites
``\\p{X}`` / ``\\P{X}`` into classes built once from ``unicodedata`` and
``\\s`` / ``\\S`` into the Unicode ``White_Space`` set.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from pathlib import Path


class UnsupportedComponent(ValueError):
    """A ``tokenizer.json`` component (or option) this reader lacks."""


# Unicode White_Space: what Oniguruma's \s and Rust's char::is_whitespace
# take (Python's \s and str.isspace add U+001C-U+001F).
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680"
               + "".join(chr(c) for c in range(0x2000, 0x200B))
               + "\u2028\u2029\u202f\u205f\u3000")
_WS = frozenset(WHITE_SPACE)


# ------------------------------------------------------------------ patterns

@functools.lru_cache(maxsize=1)
def _categories() -> list[str]:
    """The general category of every code point."""
    return [unicodedata.category(chr(c)) for c in range(sys.maxunicode + 1)]


_CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl",
               "No", "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc",
               "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf", "Cs", "Co", "Cn")


def _fmt(ranges: list[tuple[int, int]]) -> str:
    def esc(cp: int) -> str:
        return f"\\U{cp:08x}"

    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=None)
def _category_class(name: str) -> str:
    """The members of general category ``name`` (``L``, ``Lu``, ``N``,
    ...) as the inside of a character class."""
    if name not in _CATEGORIES and name not in {c[0] for c in _CATEGORIES}:
        raise UnsupportedComponent(f"pattern property \\p{{{name}}}")
    ranges: list[tuple[int, int]] = []
    lo = None
    for cp, cat in enumerate(_categories()):
        hit = cat.startswith(name)
        if hit and lo is None:
            lo = cp
        elif not hit and lo is not None:
            ranges.append((lo, cp - 1))
            lo = None
    if lo is not None:
        ranges.append((lo, sys.maxunicode))
    return _fmt(ranges)


_WS_CLASS = _fmt([(ord(c), ord(c)) for c in WHITE_SPACE])


def onig_to_re(pattern: str) -> str:
    """An Oniguruma pattern as one Python's ``re`` reads the same way:
    ``\\p{X}``, ``\\P{X}``, ``\\pX`` and ``\\s``, ``\\S`` spelled out as
    classes (inside a class, their members)."""
    out: list[str] = []
    i, n, depth = 0, len(pattern), 0
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    j = pattern.index("}", i + 3)
                    name, i = pattern[i + 3:j], j + 1
                else:
                    name, i = pattern[i + 2], i + 3
                neg = e == "P"
                if name.startswith("^"):
                    name, neg = name[1:], not neg
                members = _category_class(name)
                if depth:
                    if neg:
                        raise UnsupportedComponent(
                            f"negated property \\P{{{name}}} inside a "
                            f"character class in {pattern!r}")
                    out.append(members)
                else:
                    out.append(f"[{'^' if neg else ''}{members}]")
                continue
            if e in "sS":
                if depth:
                    if e == "S":
                        raise UnsupportedComponent(
                            f"\\S inside a character class in {pattern!r}")
                    out.append(_WS_CLASS)
                else:
                    out.append(f"[{'^' if e == 'S' else ''}{_WS_CLASS}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[":
            if depth and pattern.startswith("[:", i):
                raise UnsupportedComponent(
                    f"POSIX bracket in {pattern!r}")
            depth += 1
            out.append(c)
            i += 1
            # A ']' right after '[' or '[^' is a literal member.
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and depth:
            depth -= 1
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=256)
def _compile(pattern: str) -> re.Pattern:
    return re.compile(onig_to_re(pattern))


def _pattern(spec: dict) -> re.Pattern:
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern, compiled."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return _compile(spec["Regex"])
    raise UnsupportedComponent(f"pattern {spec!r}")


# --------------------------------------------------------- normalized strings

class NormalizedString:
    """A piece of text and, per character, the offset in the original
    text it came from (what Metaspace's ``prepend_scheme: first`` reads)."""

    __slots__ = ("text", "orig")

    def __init__(self, text: str, orig: list[int]):
        self.text = text
        self.orig = orig

    @classmethod
    def of(cls, text: str, start: int = 0) -> "NormalizedString":
        return cls(text, list(range(start, start + len(text))))

    def start(self) -> int:
        return self.orig[0] if self.orig else 0

    def slice(self, a: int, b: int) -> "NormalizedString":
        return NormalizedString(self.text[a:b], self.orig[a:b])

    def prepend(self, s: str) -> None:
        if self.text:
            self.orig = [self.orig[0]] * len(s) + self.orig
            self.text = s + self.text

    def replace(self, rx: re.Pattern, content: str) -> None:
        text, orig, pos = [], [], 0
        for m in rx.finditer(self.text):
            a, b = m.span()
            if a == b:
                continue
            text.append(self.text[pos:a])
            orig.extend(self.orig[pos:a])
            text.append(content)
            orig.extend([self.orig[a]] * len(content))
            pos = b
        text.append(self.text[pos:])
        orig.extend(self.orig[pos:])
        self.text, self.orig = "".join(text), orig

    def unicode_normalize(self, form: str) -> None:
        whole = unicodedata.normalize(form, self.text)
        if whole == self.text:
            return
        # Align segment by segment (each starts at a starter); where the
        # segments do not compose to the whole, every character keeps the
        # piece's first offset.
        segs, cur = [], 0
        for k in range(1, len(self.text) + 1):
            if k == len(self.text) or unicodedata.combining(
                    self.text[k]) == 0:
                segs.append((cur, k))
                cur = k
        text, orig = [], []
        for a, b in segs:
            part = unicodedata.normalize(form, self.text[a:b])
            text.append(part)
            orig.extend([self.orig[a]] * len(part))
        if "".join(text) != whole:
            orig = [self.start()] * len(whole)
        self.text, self.orig = whole, orig


def _split(ns: NormalizedString, spans: list[tuple[int, int]],
           behavior: str, invert: bool = False) -> list[NormalizedString]:
    """``NormalizedString::split`` of ``tokenizers``: the pieces around
    and of the matches ``spans`` under ``behavior``; empty pieces
    dropped."""
    text = ns.text
    if not text:
        marks = [((0, 0), False)]
    else:
        marks, prev = [], 0
        for a, b in spans:
            if prev != a:
                marks.append(((prev, a), False))
            marks.append(((a, b), True))
            prev = b
        if prev != len(text):
            marks.append(((prev, len(text)), False))
    if invert:
        marks = [(o, not m) for o, m in marks]
    if behavior == "Isolated":
        cuts = [(o, False) for o, _ in marks]
    elif behavior == "Removed":
        cuts = marks
    elif behavior == "Contiguous":
        cuts, prev_match = [], False
        for (a, b), m in marks:
            if m == prev_match and cuts:
                cuts[-1] = ((cuts[-1][0][0], b), False)
            else:
                cuts.append(((a, b), False))
            prev_match = m
    elif behavior == "MergedWithPrevious":
        cuts, prev_match = [], False
        for (a, b), m in marks:
            if m and not prev_match and cuts:
                cuts[-1] = ((cuts[-1][0][0], b), False)
            else:
                cuts.append(((a, b), False))
            prev_match = m
    elif behavior == "MergedWithNext":
        cuts, prev_match = [], False
        for (a, b), m in reversed(marks):
            if m and not prev_match and cuts:
                cuts[-1] = ((a, cuts[-1][0][1]), False)
            else:
                cuts.append(((a, b), False))
            prev_match = m
        cuts.reverse()
    else:
        raise UnsupportedComponent(f"split behavior {behavior!r}")
    return [ns.slice(a, b) for (a, b), removed in cuts
            if not removed and b > a]


# ------------------------------------------------------------ normalizers

def _normalizer(spec: dict | None):
    """A function normalizing a NormalizedString in place."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(ns):
            for p in parts:
                p(ns)
        return run
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda ns: ns.prepend(prefix)
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda ns: ns.replace(rx, content)
    if kind in ("NFC", "NFKC"):
        return lambda ns: ns.unicode_normalize(kind)
    raise UnsupportedComponent(f"normalizer {kind!r}")


# ------------------------------------------------------------ pre-tokenizers

def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map (the ByteLevel alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}
_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
               r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _byte_map(ns: NormalizedString) -> NormalizedString:
    text, orig = [], []
    for ch, o in zip(ns.text, ns.orig):
        for b in ch.encode("utf-8"):
            text.append(BYTE_CHAR[b])
            orig.append(o)
    return NormalizedString("".join(text), orig)


def _pre_tokenizer(spec: dict | None):
    """A function from a list of NormalizedStrings to the next list."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return run
    if kind == "Split":
        rx = _pattern(spec["pattern"])
        behavior, invert = spec["behavior"], bool(spec.get("invert"))

        def run(pieces):
            return [s for ns in pieces for s in _split(
                ns, [m.span() for m in rx.finditer(ns.text)], behavior,
                invert)]
        return run
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space"))
        rx = _compile(_GPT2_SPLIT) if spec.get("use_regex", True) else None

        def run(pieces):
            out = []
            for ns in pieces:
                if prefix and not ns.text.startswith(" "):
                    ns.prepend(" ")
                subs = ([ns] if rx is None else _split(
                    ns, [m.span() for m in rx.finditer(ns.text)],
                    "Isolated"))
                out.extend(_byte_map(s) for s in subs)
            return out
        return run
    if kind == "Metaspace":
        repl = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # files older than prepend_scheme
            scheme = "always" if spec.get("add_prefix_space", True) else \
                "never"
        if scheme not in ("always", "first", "never"):
            raise UnsupportedComponent(f"Metaspace prepend_scheme {scheme!r}")
        split = spec.get("split", True)
        space = re.compile(" ")

        def run(pieces):
            out = []
            for ns in pieces:
                ns.replace(space, repl)
                if (scheme == "always" or (scheme == "first"
                                           and ns.start() == 0)):
                    if not ns.text.startswith(repl):
                        ns.prepend(repl)
                if split:
                    spans = [(k, k + 1) for k, ch in enumerate(ns.text)
                             if ch == repl]
                    out.extend(_split(ns, spans, "MergedWithNext"))
                elif ns.text:
                    out.append(ns)
            return out
        return run
    if kind == "Digits":
        individual = bool(spec.get("individual_digits"))

        def run(pieces):
            out = []
            for ns in pieces:
                spans = [(k, k + 1) for k, ch in enumerate(ns.text)
                         if unicodedata.category(ch) in ("Nd", "Nl", "No")]
                out.extend(_split(ns, spans, "Isolated" if individual
                                  else "Contiguous"))
            return out
        return run
    raise UnsupportedComponent(f"pre_tokenizer {kind!r}")


# ------------------------------------------------------------------ the model

class BPE:
    """The ``BPE`` model of a tokenizer.json."""

    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise UnsupportedComponent(f"model {spec.get('type')!r}")
        for key in ("continuing_subword_prefix", "end_of_word_suffix",
                    "dropout"):
            if spec.get(key):
                raise UnsupportedComponent(f"BPE {key}={spec[key]!r}")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ") if isinstance(m, str) else m
            if a not in self.vocab or b not in self.vocab:
                raise ValueError(f"merge {m!r}: a part is not in the vocab")
            if a + b not in self.vocab:
                raise ValueError(f"merge {m!r}: {a + b!r} is not in the "
                                 f"vocab")
            self.merges.setdefault((self.vocab[a], self.vocab[b]),
                                   (rank, self.vocab[a + b]))
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is None:
            hit = self._tokenize(word)
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return hit

    def _tokenize(self, word: str) -> list[int]:
        vocab = self.vocab
        if self.ignore_merges and word in vocab:
            return [vocab[word]]
        syms: list[int] = []
        unk = None  # the pending unknown run (fused when fuse_unk)
        for ch in word:
            tid = vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                ids = [vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(i is not None for i in ids):
                    syms.extend(ids)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in vocab:
                    raise ValueError(f"unk_token {self.unk_token!r} is not "
                                     f"in the vocab")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = vocab[self.unk_token]
        if unk is not None:
            syms.append(unk)
        return self._merge(syms)

    def _merge(self, syms: list[int]) -> list[int]:
        """``Word::merge_all`` of ``tokenizers``: a heap of (rank, position,
        new id) over adjacent pairs, lowest rank (then leftmost) merged
        first; an entry whose pair no longer makes its new id is stale."""
        merges = self.merges
        n = len(syms)
        if n < 2:
            return syms
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for k in range(n - 1):
            m = merges.get((syms[k], syms[k + 1]))
            if m is not None:
                heap.append((m[0], k, m[1]))
        heapq.heapify(heap)
        while heap:
            _, k, new = heapq.heappop(heap)
            q = nxt[k]
            if not alive[k] or q < 0:
                continue
            m = merges.get((syms[k], syms[q]))
            if m is None or m[1] != new:
                continue
            syms[k] = new
            alive[q] = False
            nxt[k] = nxt[q]
            if nxt[q] >= 0:
                prv[nxt[q]] = k
            if prv[k] >= 0:
                m = merges.get((syms[prv[k]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[k], m[1]))
            if nxt[k] >= 0:
                m = merges.get((new, syms[nxt[k]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], k, m[1]))
        return [t for t, a in zip(syms, alive) if a]


# ------------------------------------------------------------ post-processors

def _template(items: list) -> list:
    out = []
    for it in items:
        if "SpecialToken" in it:
            out.append(("special", it["SpecialToken"]["id"]))
        elif "Sequence" in it:
            out.append(("seq", it["Sequence"]["id"]))
        else:
            raise UnsupportedComponent(f"TemplateProcessing piece {it!r}")
    return out


def _post_processor(spec: dict | None):
    """A function (ids) -> ids adding a single sequence's specials."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_post_processor(s) for s in spec["processors"]]

        def run(ids):
            for p in parts:
                if p is not None:
                    ids = p(ids)
            return ids
        return run
    if kind == "ByteLevel":  # offsets only
        return None
    if kind == "TemplateProcessing":
        single = _template(spec["single"])
        specials = {k: list(v["ids"]) for k, v in
                    (spec.get("special_tokens") or {}).items()}
        for what, name in single:
            if what == "special" and name not in specials:
                raise ValueError(f"TemplateProcessing: special token "
                                 f"{name!r} has no ids")

        def run(ids):
            out = []
            for what, name in single:
                out.extend(ids if what == "seq" else specials[name])
            return out
        return run
    raise UnsupportedComponent(f"post_processor {kind!r}")


# ------------------------------------------------------------------ decoders

def _decoder(spec: dict | None):
    """A function from a list of token strings to the next list."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def run(toks):
            for p in parts:
                toks = p(toks)
            return toks
        return run
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda toks: [rx.sub(lambda _: content, t) for t in toks]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        content = spec["content"]
        start, stop = int(spec["start"]), int(spec["stop"])

        def run(toks):
            out = []
            for t in toks:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                while b > a and len(t) - b < stop and t[b - 1] == content:
                    b -= 1
                out.append(t[a:b])
            return out
        return run
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Metaspace":
        repl = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else \
                "never"

        def run(toks):
            return ["".join(("" if i == 0 and scheme != "never" else " ")
                            if ch == repl else ch for ch in t)
                    for i, t in enumerate(toks)]
        return run
    raise UnsupportedComponent(f"decoder {kind!r}")


def _byte_token(t: str) -> int | None:
    if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
        try:
            return int(t[3:5], 16)
        except ValueError:
            return None
    return None


def _byte_fallback(toks: list[str]) -> list[str]:
    out: list[str] = []
    pending: list[int] = []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in toks:
        b = _byte_token(t)
        if b is not None:
            pending.append(b)
        else:
            flush()
            out.append(t)
    flush()
    return out


def _byte_level_decode(toks: list[str]) -> list[str]:
    data = bytearray()
    for t in toks:
        if all(ch in CHAR_BYTE for ch in t):
            data.extend(CHAR_BYTE[ch] for ch in t)
        else:
            data.extend(t.encode("utf-8"))
    return [bytes(data).decode("utf-8", errors="replace")]


# ----------------------------------------------------------------- the whole

class AddedToken:
    __slots__ = ("id", "content", "single_word", "lstrip", "rstrip",
                 "normalized", "special")

    def __init__(self, spec: dict):
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.single_word = bool(spec.get("single_word"))
        self.lstrip = bool(spec.get("lstrip"))
        self.rstrip = bool(spec.get("rstrip"))
        self.special = bool(spec.get("special"))
        self.normalized = bool(spec.get("normalized", not self.special))


def _is_word(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


class TokenizerJSON:
    """A ``tokenizer.json`` loaded: :meth:`encode`, :meth:`decode`,
    :meth:`id_to_token`, :meth:`token_to_id`."""

    def __init__(self, doc: dict):
        for key in ("truncation", "padding"):
            if doc.get(key):
                raise UnsupportedComponent(f"{key} {doc[key]!r}")
        self.model = BPE(doc["model"])
        self.normalizer = _normalizer(doc.get("normalizer"))
        self.set_pre_tokenizer(doc.get("pre_tokenizer"))
        self.post_processor = _post_processor(doc.get("post_processor"))
        self.decoder = _decoder(doc.get("decoder"))
        self.added: dict[int, AddedToken] = {}
        for spec in doc.get("added_tokens") or []:
            self._add(AddedToken(spec))
        self._reverse = {i: t for t, i in self.model.vocab.items()}

    @classmethod
    def from_file(cls, path: str | Path) -> "TokenizerJSON":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    # ---- added tokens

    def _add(self, tok: AddedToken) -> None:
        self.added[tok.id] = tok
        self._matchers = None

    def add_token(self, content: str, special: bool) -> int:
        """Add ``content`` as ``add_tokens`` of ``tokenizers`` does: a
        content already added is left as it is; else it takes the model's
        id, else the next free id."""
        tid = self.token_to_id(content)
        if tid is not None and any(t.content == content
                                   for t in self.added.values()):
            return tid
        if tid is None:
            tid = max([len(self.model.vocab) - 1, *self.added]) + 1
        self._add(AddedToken(dict(id=tid, content=content, special=special)))
        return tid

    def _matcher(self, normalized: bool):
        if self._matchers is None:
            self._matchers = {}
            for norm in (False, True):
                toks = [t for t in self.added.values()
                        if t.normalized == norm]
                by_content: dict[str, AddedToken] = {}
                for t in sorted(toks, key=lambda t: t.id):
                    key = t.content
                    if norm and self.normalizer is not None:
                        ns = NormalizedString.of(key)
                        self.normalizer(ns)
                        key = ns.text
                    by_content.setdefault(key, t)
                if by_content:
                    rx = re.compile("|".join(
                        re.escape(k) for k in sorted(by_content, key=len,
                                                     reverse=True) if k))
                else:
                    rx = None
                self._matchers[norm] = (rx, by_content)
        return self._matchers[normalized]

    def _split_added(self, ns: NormalizedString, normalized: bool
                     ) -> list[tuple[NormalizedString, int | None]]:
        rx, by_content = self._matcher(normalized)
        text = ns.text
        if rx is None or not text:
            return [(ns, None)] if text else []
        out: list[tuple[NormalizedString, int | None]] = []
        pos = 0
        for m in rx.finditer(text):
            a, b = m.span()
            tok = by_content[m.group()]
            if tok.single_word:
                if (a > 0 and _is_word(text[a - 1])) or (
                        b < len(text) and _is_word(text[b])):
                    continue
            if tok.lstrip:
                while a > pos and text[a - 1] in _WS:
                    a -= 1
            if tok.rstrip:
                while b < len(text) and text[b] in _WS:
                    b += 1
            if pos < a:
                out.append((ns.slice(pos, a), None))
            out.append((ns.slice(a, b), tok.id))
            pos = b
        if pos < len(text):
            out.append((ns.slice(pos, len(text)), None))
        return out

    # ---- encode / decode

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> list[int]:
        pieces: list[tuple[NormalizedString, int | None]] = []
        for ns, tid in self._split_added(NormalizedString.of(text), False):
            if tid is not None:
                pieces.append((ns, tid))
                continue
            if self.normalizer is not None:
                self.normalizer(ns)
            pieces.extend(self._split_added(ns, True))
        ids: list[int] = []
        for ns, tid in pieces:
            if tid is not None:
                ids.append(tid)
                continue
            words = ([ns] if self.pre_tokenizer is None
                     else self.pre_tokenizer([ns]))
            for w in words:
                ids.extend(self.model.tokenize(w.text))
        if add_special_tokens and self.post_processor is not None:
            ids = self.post_processor(ids)
        return ids

    def id_to_token(self, tid: int) -> str | None:
        tok = self.added.get(tid)
        if tok is not None:
            return tok.content
        return self._reverse.get(tid)

    def token_to_id(self, token: str) -> int | None:
        for t in self.added.values():
            if t.content == token:
                return t.id
        return self.model.vocab.get(token)

    def is_special(self, tid: int) -> bool:
        tok = self.added.get(tid)
        return tok is not None and tok.special

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        toks = []
        for tid in ids:
            t = self.id_to_token(int(tid))
            if t is None or (skip_special_tokens and self.is_special(tid)):
                continue
            toks.append(t)
        if self.decoder is None:
            return " ".join(toks)
        return "".join(self.decoder(toks))

    def set_pre_tokenizer(self, spec: dict | None) -> None:
        self.pre_tokenizer_spec = spec
        self.pre_tokenizer = _pre_tokenizer(spec)

    def set_template(self, single: list, special_tokens: dict) -> None:
        """Replace the post-processor by a TemplateProcessing (what a
        ``tokenizer_class`` that rebuilds it from ``add_bos_token`` /
        ``add_eos_token`` does)."""
        self.post_processor = _post_processor(
            {"type": "TemplateProcessing", "single": single,
             "special_tokens": special_tokens})
