"""Chat templates: a renderer for the Jinja2 subset HF chat templates use.

The port's own counterpart of what ``apply_chat_template`` renders (the
card has no ``jinja2``), in the environment ``transformers`` sets up:
``trim_blocks`` and ``lstrip_blocks`` on, ``{%- -%}`` / ``{{- -}}``
whitespace control, one trailing newline of the source dropped, the
``loopcontrols`` extension, ``tojson`` as ``json.dumps`` without ASCII
escapes, and the globals ``raise_exception`` and ``strftime_now``; the
variables are ``messages``, ``add_generation_prompt`` and the special
tokens (``bos_token``, ``eos_token``, ...).

The subset, what the registry families' templates use: ``for``
(unpacking targets, an ``if`` filter, ``else``, ``loop.*``, ``break`` /
``continue``), ``if`` / ``elif`` / ``else``, ``set`` (a name or
``ns.attr``); literals, ``~`` and arithmetic, comparisons, ``in``,
``not`` / ``and`` / ``or``, conditional expressions, attribute and item
access, slicing, calls, the tests and filters named in ``TESTS`` and
``FILTERS``, the string methods and dicts' read-only methods of
``_SAFE_METHODS``, ``namespace`` and ``range``.  Scoping is Jinja's: each
loop iteration gets its own frame, so a ``set`` inside a loop does not
leak out (templates carry state across iterations in a ``namespace``).
A template using anything else raises :class:`UnsupportedConstruct` when
it is parsed, naming the construct; :func:`load_template` logs that and
returns None, and the engine then flattens the chat.  A template that
raises while it renders (``raise_exception``, an undefined value's
attribute) raises :class:`TemplateError`.
"""

from __future__ import annotations

import json
import logging
import re
from datetime import datetime
from pathlib import Path

log = logging.getLogger("crowdllama.torch.engine.chat_template")


class UnsupportedConstruct(ValueError):
    """A template construct outside the subset this module renders."""


class TemplateError(Exception):
    """A template failed while rendering (Jinja's ``TemplateError``)."""


# ------------------------------------------------------------------ values

class Undefined:
    """Jinja's default ``Undefined``: renders as "", is false, iterates as
    empty, and raises when its attributes or items are read."""

    __slots__ = ("name",)

    def __init__(self, name: str = ""):
        self.name = name

    def _fail(self, *_a, **_k):
        raise TemplateError(f"{self.name!r} is undefined")

    __getattr__ = _fail
    __getitem__ = _fail
    __call__ = _fail
    __add__ = __radd__ = __mul__ = __rmul__ = __sub__ = _fail

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Undefined)

    def __hash__(self) -> int:
        return 0


class Namespace:
    """``namespace(...)``: the one object a template may assign into."""

    def __init__(self, **kw):
        self.__dict__["_attrs"] = dict(kw)

    def __getattr__(self, name):
        try:
            return self.__dict__["_attrs"][name]
        except KeyError:
            raise AttributeError(name) from None


class LoopContext:
    def __init__(self, items: list, index0: int):
        self._items = items
        self.index0 = index0
        self.index = index0 + 1
        self.length = len(items)
        self.revindex = self.length - index0
        self.revindex0 = self.length - index0 - 1
        self.first = index0 == 0
        self.last = index0 == self.length - 1
        self.previtem = items[index0 - 1] if index0 else Undefined("previtem")
        self.nextitem = (items[index0 + 1] if index0 + 1 < self.length
                         else Undefined("nextitem"))

    def cycle(self, *args):
        return args[self.index0 % len(args)]


# Methods a template may call: these of strings, and dicts' read-only
# ones; any other a string, dict or list has is refused, as the
# immutable sandbox refuses the mutating ones.
_SAFE_METHODS = {
    str: {"strip", "lstrip", "rstrip", "split", "startswith", "endswith",
          "replace", "upper", "lower"},
    dict: {"items", "keys", "values", "get"},
    list: set(),
    tuple: set(),
}


def _method(obj, name: str):
    for typ, names in _SAFE_METHODS.items():
        if isinstance(obj, typ):
            if name in names:
                return getattr(obj, name)
            if hasattr(typ, name):
                raise TemplateError(f"access to attribute {name!r} of "
                                    f"{typ.__name__!r} object is unsafe")
    return None


def getattr_(obj, name: str):
    """Jinja's ``obj.name``: an attribute, else the item ``name``."""
    if isinstance(obj, Undefined):
        obj._fail()
    if name.startswith("_"):
        raise TemplateError(f"access to attribute {name!r} is unsafe")
    m = _method(obj, name)
    if m is not None:
        return m
    if isinstance(obj, (Namespace, LoopContext)):
        try:
            return getattr(obj, name)
        except AttributeError:
            return Undefined(name)
    try:
        return obj[name]
    except (TypeError, LookupError):
        return Undefined(name)


def getitem(obj, key):
    """Jinja's ``obj[key]``: the item, else the attribute ``key``."""
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return obj[key]
    except (TypeError, LookupError):
        if isinstance(key, str):
            return getattr_(obj, key)
        return Undefined(str(key))


def to_str(v) -> str:
    if isinstance(v, Undefined):
        return ""
    return str(v)


# ------------------------------------------------------ filters and tests

def _tojson(x, ensure_ascii=False, indent=None, separators=None,
            sort_keys=False):
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _default(v, default="", boolean=False):
    if isinstance(v, Undefined) or (boolean and not v):
        return default
    return v


def _join(v, d="", attribute=None):
    if attribute is not None:
        v = [getattr_(x, attribute) for x in v]
    return d.join(to_str(x) for x in v)


def _first(v):
    for x in v:
        return x
    return Undefined("first")


def _last(v):
    v = list(v)
    return v[-1] if v else Undefined("last")


def _length(v):
    return len(v)


def _attr_select(want: bool):
    def run(renderer, seq, attr, test=None, *args):
        out = []
        for x in seq:
            val = getattr_(x, attr) if "." not in attr else _dotted(x, attr)
            ok = (bool(val) if test is None
                  else renderer.test(test, val, list(args)))
            if ok == want:
                out.append(x)
        return out
    return run


def _dotted(x, attr: str):
    for part in attr.split("."):
        x = getattr_(x, part)
    return x


def _map(renderer, seq, *args, **kw):
    if "attribute" in kw:
        attr = kw["attribute"]
        default = kw.get("default")
        out = []
        for x in seq:
            val = _dotted(x, attr)
            out.append(default if isinstance(val, Undefined)
                       and default is not None else val)
        return out
    if not args:
        raise TemplateError("map needs a filter name or attribute=")
    name, rest = args[0], args[1:]
    return [renderer.filter(name, x, list(rest), {}) for x in seq]


def _items(v):
    if isinstance(v, Undefined):
        return []
    return list(v.items())


# name -> (function, whether it takes the renderer first): the filters
# the registry's templates use.
FILTERS = {
    "trim": (lambda s, chars=None: to_str(s).strip(chars), False),
    "length": (_length, False), "count": (_length, False),
    "tojson": (_tojson, False),
    "default": (_default, False), "d": (_default, False),
    "first": (_first, False), "last": (_last, False),
    "join": (_join, False),
    "list": (lambda v: list(v), False),
    "selectattr": (_attr_select(True), True),
    "rejectattr": (_attr_select(False), True),
    "reject": (lambda renderer, seq, test=None, *args: [
        x for x in seq if not (bool(x) if test is None else
                               renderer.test(test, x, list(args)))], True),
    "map": (_map, True),
    "items": (_items, False),
}


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, Undefined)


TESTS = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, dict),
    "number": _is_number,
    "boolean": lambda v: isinstance(v, bool),
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "iterable": lambda v: isinstance(v, (str, list, tuple, dict, set)),
    "sequence": lambda v: isinstance(v, (str, list, tuple, dict)),
    "equalto": lambda v, o: v == o, "eq": lambda v, o: v == o,
    "==": lambda v, o: v == o,
    "ne": lambda v, o: v != o, "!=": lambda v, o: v != o,
    "in": lambda v, o: v in o,
}


def _raise_exception(message):
    raise TemplateError(message)


def _strftime_now(fmt):
    return datetime.now().strftime(fmt)


def _range(*args):
    return list(range(*args))


GLOBALS = {"raise_exception": _raise_exception,
           "strftime_now": _strftime_now, "namespace": Namespace,
           "range": _range}
_UNSUPPORTED_GLOBALS = {"lipsum", "cycler", "joiner", "dict", "self",
                        "caller", "varargs", "kwargs"}


# ------------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<float>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op>\*\*|//|==|!=|<=|>=|[-+*/%~<>=()\[\]{},:.|])
""", re.VERBOSE | re.DOTALL)
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'",
            '"': '"', "0": "\0", "b": "\b", "f": "\f", "v": "\v"}


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(u[0-9a-fA-F]{4}|x[0-9a-fA-F]{2}|.)", lambda m: (
        chr(int(m.group(1)[1:], 16)) if m.group(1)[0] in "ux"
        and len(m.group(1)) > 1 else _ESCAPES.get(m.group(1),
                                                  "\\" + m.group(1))), body)


def _tokens(src: str, pos: int, end_mark: str) -> tuple[list, int, str]:
    """Tokens of one tag from ``pos`` to its closing ``end_mark`` (``%}``
    or ``}}``): (tokens, the index after the tag, "-", "+" or "" for the
    end's modifier)."""
    toks: list = []
    n = len(src)
    depth = 0
    while pos < n:
        if depth == 0:
            for mod in ("-", "+", ""):
                if src.startswith(mod + end_mark, pos):
                    return toks, pos + len(mod) + len(end_mark), mod
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise UnsupportedConstruct(
                f"character {src[pos]!r} in a tag at offset {pos}")
        kind, text = m.lastgroup, m.group()
        pos = m.end()
        if kind == "ws":
            continue
        if kind == "op" and text in "([{":
            depth += 1
        elif kind == "op" and text in ")]}":
            depth -= 1
        toks.append((kind, text))
    raise UnsupportedConstruct(f"unclosed tag (no {end_mark!r})")


_WS_RUN = re.compile(r"\s*")


def _lex(src: str) -> list:
    """The template as ("data", text) / ("var", tokens) / ("block",
    tokens) items, with Jinja's whitespace control applied to the data:
    ``-`` strips all whitespace on its side, ``trim_blocks`` drops the
    newline right after a block or comment tag, ``lstrip_blocks`` drops
    the spaces and tabs between a line's start and a block or comment
    tag, ``+`` turns either off."""
    src = src.replace("\r\n", "\n").replace("\r", "\n")
    if src.endswith("\n"):
        src = src[:-1]
    items: list = []
    pos, n = 0, len(src)
    line_starting = True
    opener = re.compile(r"\{\{|\{%|\{#")
    while True:
        m = opener.search(src, pos)
        data = src[pos:m.start()] if m else src[pos:]
        if m is None:
            if data:
                items.append(("data", data))
            return items
        kind = m.group()
        after = m.end()
        mod = src[after] if after < n and src[after] in "-+" else ""
        if mod == "-":
            data = data.rstrip()
        elif kind != "{{" and mod != "+":
            line = data.rfind("\n") + 1
            if (line > 0 or line_starting) and data[line:] \
                    and not data[line:].strip():
                data = data[:line]
        if data:
            items.append(("data", data))
        body = after + (1 if mod else 0)
        if kind == "{#":
            end = src.find("#}", body)
            if end < 0:
                raise UnsupportedConstruct("unclosed comment")
            tail = src[end - 1] if end > body and src[end - 1] in "-+" \
                else ""
            pos = end + 2
        else:
            toks, pos, tail = _tokens(src, body,
                                      "}}" if kind == "{{" else "%}")
            if kind == "{%" and toks and toks[0] == ("name", "raw"):
                raise UnsupportedConstruct("tag 'raw'")
            items.append(("var" if kind == "{{" else "block", toks))
        start = pos
        if tail == "-":
            pos = _WS_RUN.match(src, pos).end()
        elif kind != "{{" and tail != "+" and src.startswith("\n", pos):
            pos += 1
        line_starting = src[start:pos].endswith("\n")


# ------------------------------------------------------------------ parser

class _Parser:
    """Statements and expressions of the subset, as nested tuples."""

    def __init__(self, items: list):
        self.items = items
        self.i = 0

    # ---- statements

    def parse_body(self, ends: tuple = ()) -> tuple[list, str | None]:
        body: list = []
        while self.i < len(self.items):
            kind, val = self.items[self.i]
            self.i += 1
            if kind == "data":
                body.append(("data", val))
                continue
            self.toks, self.k = val, 0
            if kind == "var":
                expr = self.expr()
                self.done()
                body.append(("out", expr))
                continue
            tag = self.name()
            if tag in ends:
                return body, tag
            body.append(self.statement(tag))
        if ends:
            raise UnsupportedConstruct(f"missing {' or '.join(ends)}")
        return body, None

    def statement(self, tag: str):
        if tag == "for":
            targets = [self.name()]
            while self.peek(","):
                self.k += 1
                targets.append(self.name())
            self.want("name", "in")
            seq = self.expr(no_cond=True)
            cond = None
            if self.peek_name("if"):
                self.k += 1
                cond = self.expr(no_cond=True)
            if self.peek_name("recursive"):
                raise UnsupportedConstruct("recursive for loops")
            self.done()
            body, end = self.parse_body(("endfor", "else"))
            other: list = []
            if end == "else":
                self.done()
                other, _ = self.parse_body(("endfor",))
            self.done()
            return ("for", targets, seq, cond, body, other)
        if tag == "if":
            branches = []
            cond = self.expr()
            self.done()
            while True:
                body, end = self.parse_body(("elif", "else", "endif"))
                branches.append((cond, body))
                if end == "elif":
                    cond = self.expr()
                    self.done()
                    continue
                if end == "else":
                    self.done()
                    body, _ = self.parse_body(("endif",))
                    branches.append((None, body))
                self.done()
                return ("if", branches)
        if tag == "set":
            target = [self.name()]
            if self.peek("."):
                self.k += 1
                target.append(self.name())
            if self.peek(","):
                raise UnsupportedConstruct("set with several targets")
            if self.k == len(self.toks) or self.peek("|"):
                raise UnsupportedConstruct("set blocks")
            self.want("op", "=")
            value = self.expr()
            self.done()
            return ("set", target, value)
        if tag in ("break", "continue"):
            self.done()
            return (tag,)
        raise UnsupportedConstruct(f"tag {tag!r}")

    # ---- token helpers

    def peek(self, op: str) -> bool:
        return self.k < len(self.toks) and self.toks[self.k] == ("op", op)

    def peek_name(self, name: str) -> bool:
        return self.k < len(self.toks) and self.toks[self.k] == ("name", name)

    def next(self):
        if self.k >= len(self.toks):
            raise UnsupportedConstruct("unexpected end of a tag")
        tok = self.toks[self.k]
        self.k += 1
        return tok

    def name(self) -> str:
        kind, text = self.next()
        if kind != "name":
            raise UnsupportedConstruct(f"expected a name, got {text!r}")
        return text

    def want(self, kind: str, text: str) -> None:
        tok = self.next()
        if tok != (kind, text):
            raise UnsupportedConstruct(f"expected {text!r}, got {tok[1]!r}")

    def done(self) -> None:
        if self.k != len(self.toks):
            raise UnsupportedConstruct(
                f"unexpected {self.toks[self.k][1]!r} in a tag")

    # ---- expressions (Jinja's precedence)

    def expr(self, no_cond: bool = False):
        node = self.or_()
        if not no_cond and self.peek_name("if"):
            self.k += 1
            cond = self.or_()
            other = None
            if self.peek_name("else"):
                self.k += 1
                other = self.expr()
            node = ("cond", cond, node, other)
        return node

    def or_(self):
        node = self.and_()
        while self.peek_name("or"):
            self.k += 1
            node = ("or", node, self.and_())
        return node

    def and_(self):
        node = self.not_()
        while self.peek_name("and"):
            self.k += 1
            node = ("and", node, self.not_())
        return node

    def not_(self):
        if self.peek_name("not"):
            self.k += 1
            return ("not", self.not_())
        return self.compare()

    def compare(self):
        node = self.math1()
        ops = []
        while True:
            if self.k < len(self.toks) and self.toks[self.k][0] == "op" \
                    and self.toks[self.k][1] in ("==", "!=", "<", ">", "<=",
                                                 ">="):
                op = self.next()[1]
            elif self.peek_name("in"):
                self.k += 1
                op = "in"
            elif (self.peek_name("not") and self.k + 1 < len(self.toks)
                  and self.toks[self.k + 1] == ("name", "in")):
                self.k += 2
                op = "not in"
            else:
                break
            ops.append((op, self.math1()))
        return ("compare", node, ops) if ops else node

    def math1(self):
        node = self.concat()
        while self.peek("+") or self.peek("-"):
            op = self.next()[1]
            node = ("bin", op, node, self.concat())
        return node

    def concat(self):
        node = self.math2()
        while self.peek("~"):
            self.k += 1
            node = ("concat", node, self.math2())
        return node

    def math2(self):
        node = self.pow_()
        while (self.peek("*") or self.peek("/") or self.peek("//")
               or self.peek("%")):
            op = self.next()[1]
            node = ("bin", op, node, self.pow_())
        return node

    def pow_(self):
        node = self.unary()
        while self.peek("**"):
            self.k += 1
            node = ("bin", "**", node, self.unary())
        return node

    def unary(self, with_filter: bool = True):
        if self.peek("-"):
            self.k += 1
            node = ("neg", self.unary(False))
        elif self.peek("+"):
            self.k += 1
            node = self.unary(False)
        else:
            node = self.primary()
        node = self.postfix(node)
        return self.filters(node) if with_filter else node

    def primary(self):
        kind, text = self.next()
        if kind == "name":
            if text in ("true", "True"):
                return ("const", True)
            if text in ("false", "False"):
                return ("const", False)
            if text in ("none", "None"):
                return ("const", None)
            if text in _UNSUPPORTED_GLOBALS:
                raise UnsupportedConstruct(f"global {text!r}")
            return ("name", text)
        if kind == "int":
            return ("const", int(text))
        if kind == "float":
            return ("const", float(text))
        if kind == "str":
            value = _unquote(text)
            # Adjacent string literals concatenate.
            while self.k < len(self.toks) and self.toks[self.k][0] == "str":
                value += _unquote(self.next()[1])
            return ("const", value)
        if text == "(":
            if self.peek(")"):
                self.k += 1
                return ("tuple", [])
            node = self.expr()
            if self.peek(","):
                elems = [node]
                while self.peek(","):
                    self.k += 1
                    if self.peek(")"):
                        break
                    elems.append(self.expr())
                node = ("tuple", elems)
            self.want("op", ")")
            return node
        if text == "[":
            elems = []
            while not self.peek("]"):
                elems.append(self.expr())
                if not self.peek("]"):
                    self.want("op", ",")
            self.k += 1
            return ("list", elems)
        if text == "{":
            pairs = []
            while not self.peek("}"):
                key = self.expr()
                self.want("op", ":")
                pairs.append((key, self.expr()))
                if not self.peek("}"):
                    self.want("op", ",")
            self.k += 1
            return ("dict", pairs)
        raise UnsupportedConstruct(f"unexpected {text!r}")

    def postfix(self, node):
        while True:
            if self.peek("."):
                self.k += 1
                kind, text = self.next()
                if kind == "int":
                    node = ("item", node, ("const", int(text)))
                elif kind == "name":
                    node = ("attr", node, text)
                else:
                    raise UnsupportedConstruct(f"attribute {text!r}")
            elif self.peek("["):
                self.k += 1
                node = self.subscript(node)
            elif self.peek("("):
                self.k += 1
                args, kwargs = self.call_args()
                node = ("call", node, args, kwargs)
            else:
                return node

    def subscript(self, node):
        parts: list = [None]
        while not self.peek("]"):
            if self.peek(":"):
                self.k += 1
                parts.append(None)
            else:
                parts[-1] = self.expr()
        self.k += 1
        if len(parts) == 1:
            return ("item", node, parts[0])
        if len(parts) > 3:
            raise UnsupportedConstruct("a slice with more than two ':'")
        return ("slice", node, *(parts + [None] * (3 - len(parts))))

    def call_args(self):
        args, kwargs = [], {}
        while not self.peek(")"):
            if (self.k + 1 < len(self.toks) and self.toks[self.k][0] == "name"
                    and self.toks[self.k + 1] == ("op", "=")):
                key = self.name()
                self.k += 1
                kwargs[key] = self.expr()
            else:
                if self.peek("*") or self.peek("**"):
                    raise UnsupportedConstruct("*args / **kwargs in a call")
                args.append(self.expr())
            if not self.peek(")"):
                self.want("op", ",")
        self.k += 1
        return args, kwargs

    def filters(self, node):
        while True:
            if self.peek("|"):
                self.k += 1
                name = self.name()
                if name not in FILTERS:
                    raise UnsupportedConstruct(f"filter {name!r}")
                args, kwargs = [], {}
                if self.peek("("):
                    self.k += 1
                    args, kwargs = self.call_args()
                node = ("filter", name, node, args, kwargs)
            elif self.peek_name("is"):
                self.k += 1
                neg = False
                if self.peek_name("not"):
                    self.k += 1
                    neg = True
                kind, name = self.next()
                if kind == "name" and name in ("none", "true", "false"):
                    pass
                elif name not in TESTS:
                    raise UnsupportedConstruct(f"test {name!r}")
                args = []
                if self.peek("("):
                    self.k += 1
                    args, _ = self.call_args()
                elif (self.k < len(self.toks) and not self.peek(")")
                      and self.toks[self.k][0] in ("name", "int", "float",
                                                   "str")
                      and self.toks[self.k][1] not in (
                          "and", "or", "else", "if", "in", "not", "is")):
                    args = [self.postfix(self.primary())]
                node = ("test", name, node, args, neg)
            else:
                return node


# ---------------------------------------------------------------- renderer

class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class Template:
    """A parsed chat template: :meth:`render` with the template's
    variables as keywords."""

    def __init__(self, source: str):
        self.source = source
        self.body, _ = _Parser(_lex(source)).parse_body()

    def render(self, **variables) -> str:
        out: list[str] = []
        try:
            self.exec(self.body, [dict(GLOBALS), dict(variables)], out)
        except (_Break, _Continue):
            raise TemplateError("break or continue outside a loop") \
                from None
        except TemplateError:
            raise
        except (TypeError, ValueError, KeyError, IndexError,
                AttributeError, ZeroDivisionError) as e:
            raise TemplateError(f"{type(e).__name__}: {e}") from e
        return "".join(out)

    # ---- statements

    def exec(self, body: list, frame: list, out: list) -> None:
        for node in body:
            kind = node[0]
            if kind == "data":
                out.append(node[1])
            elif kind == "out":
                out.append(to_str(self.eval(node[1], frame)))
            elif kind == "if":
                for cond, branch in node[1]:
                    if cond is None or self.eval(cond, frame):
                        self.exec(branch, frame, out)
                        break
            elif kind == "for":
                self.exec_for(node, frame, out)
            elif kind == "set":
                self.assign(node[1], self.eval(node[2], frame), frame)
            elif kind == "break":
                raise _Break
            elif kind == "continue":
                raise _Continue

    def assign(self, target: list, value, frame: list) -> None:
        if len(target) == 1:
            frame[-1][target[0]] = value
            return
        ns = self.lookup(target[0], frame)
        if not isinstance(ns, Namespace):
            raise TemplateError("can only assign attributes of a namespace")
        ns.__dict__["_attrs"][target[1]] = value

    def exec_for(self, node, frame: list, out: list) -> None:
        _, targets, seq_node, cond, body, other = node
        seq = self.eval(seq_node, frame)
        if isinstance(seq, dict):
            seq = list(seq)
        items = list(seq)
        if cond is not None:
            kept = []
            for item in items:
                local = self._bind(targets, item)
                if self.eval(cond, [*frame, local]):
                    kept.append(item)
            items = kept
        if not items:
            self.exec(other, frame, out)
            return
        for i, item in enumerate(items):
            local = self._bind(targets, item)
            local["loop"] = LoopContext(items, i)
            try:
                self.exec(body, [*frame, local], out)
            except _Break:
                break
            except _Continue:
                continue

    @staticmethod
    def _bind(targets: list, item) -> dict:
        if len(targets) == 1:
            return {targets[0]: item}
        values = list(item)
        if len(values) != len(targets):
            raise TemplateError(f"cannot unpack {len(values)} values into "
                                f"{len(targets)} names")
        return dict(zip(targets, values))

    # ---- expressions

    @staticmethod
    def lookup(name: str, frame: list):
        for scope in reversed(frame):
            if name in scope:
                return scope[name]
        return Undefined(name)

    def eval(self, node, frame: list):
        kind = node[0]
        if kind == "const":
            return node[1]
        if kind == "name":
            return self.lookup(node[1], frame)
        if kind == "attr":
            return getattr_(self.eval(node[1], frame), node[2])
        if kind == "item":
            return getitem(self.eval(node[1], frame),
                           self.eval(node[2], frame))
        if kind == "slice":
            obj = self.eval(node[1], frame)
            if isinstance(obj, Undefined):
                obj._fail()
            a, b, c = (None if x is None else self.eval(x, frame)
                       for x in node[2:5])
            return obj[a:b:c]
        if kind == "call":
            fn = self.eval(node[1], frame)
            args = [self.eval(a, frame) for a in node[2]]
            kwargs = {k: self.eval(v, frame) for k, v in node[3].items()}
            if isinstance(fn, Undefined):
                fn._fail()
            if not callable(fn):
                raise TemplateError(f"{fn!r} is not callable")
            return fn(*args, **kwargs)
        if kind == "filter":
            value = self.eval(node[2], frame)
            args = [self.eval(a, frame) for a in node[3]]
            kwargs = {k: self.eval(v, frame) for k, v in node[4].items()}
            return self.filter(node[1], value, args, kwargs)
        if kind == "test":
            value = self.eval(node[2], frame)
            args = [self.eval(a, frame) for a in node[3]]
            return self.test(node[1], value, args) != node[4]
        if kind == "not":
            return not self.eval(node[1], frame)
        if kind == "and":
            left = self.eval(node[1], frame)
            return self.eval(node[2], frame) if left else left
        if kind == "or":
            left = self.eval(node[1], frame)
            return left if left else self.eval(node[2], frame)
        if kind == "cond":
            if self.eval(node[1], frame):
                return self.eval(node[2], frame)
            return (Undefined("else") if node[3] is None
                    else self.eval(node[3], frame))
        if kind == "compare":
            left = self.eval(node[1], frame)
            for op, rnode in node[2]:
                right = self.eval(rnode, frame)
                if not _compare(op, left, right):
                    return False
                left = right
            return True
        if kind == "concat":
            return (to_str(self.eval(node[1], frame))
                    + to_str(self.eval(node[2], frame)))
        if kind == "bin":
            return _binary(node[1], self.eval(node[2], frame),
                           self.eval(node[3], frame))
        if kind == "neg":
            return -self.eval(node[1], frame)
        if kind == "list":
            return [self.eval(x, frame) for x in node[1]]
        if kind == "tuple":
            return tuple(self.eval(x, frame) for x in node[1])
        if kind == "dict":
            return {self.eval(k, frame): self.eval(v, frame)
                    for k, v in node[1]}
        raise UnsupportedConstruct(f"expression {kind!r}")

    def filter(self, name: str, value, args: list, kwargs: dict):
        fn, wants_renderer = FILTERS[name]
        if wants_renderer:
            return fn(self, value, *args, **kwargs)
        return fn(value, *args, **kwargs)

    def test(self, name: str, value, args: list) -> bool:
        if name == "none":
            return value is None
        if name in ("true", "false"):
            return value is (name == "true")
        return bool(TESTS[name](value, *args))


def _compare(op: str, a, b) -> bool:
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "in":
        return a in b
    return a not in b  # "not in"


def _binary(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "//":
        return a // b
    if op == "%":
        return a % b
    return a ** b


# ------------------------------------------------------------------ loading

def template_source(root: str | Path, tokenizer_config: dict) -> str | None:
    """The chat template text as ``transformers`` reads it: the
    directory's ``chat_template.jinja``, else ``tokenizer_config.json``'s
    ``chat_template`` (a list of named templates: the one named
    ``default``)."""
    path = Path(root) / "chat_template.jinja"
    if path.exists():
        return path.read_text(encoding="utf-8")
    tpl = tokenizer_config.get("chat_template")
    if isinstance(tpl, list):
        named = {t["name"]: t["template"] for t in tpl}
        tpl = named.get("default")
    return tpl or None


def load_template(root: str | Path, tokenizer_config: dict
                  ) -> Template | None:
    """The directory's chat template parsed, or None when it has none or
    uses a construct outside the subset (logged, naming it)."""
    src = template_source(root, tokenizer_config)
    if src is None:
        return None
    try:
        return Template(src)
    except UnsupportedConstruct as e:
        log.warning("chat template of %s uses a construct this package "
                    "does not render (%s); chats are flattened", root, e)
        return None
