"""ffi-contract checker: the C ABI seam between the native plane and
ctypes.

Counterpart of ``crowdllama_tpu/analysis/ffi_contract.py``.  Every
``extern "C"`` function of ``native/_src/*.cpp`` must have a matching
declaration in ``native/__init__.py``'s ``_declare``, and every
declaration must name a function the source exports.  The port declares
its signatures in one dict, ``sigs = {name: (restype, [argtypes])}``,
with local aliases (``sz``, ``vp``, ``cp``, ``u8p``), applied in a loop;
this checker reads that dict and resolves the aliases.  An argtypes list
one entry short, or an ``int`` restype for a pointer, corrupts memory
instead of raising, so drift fails here:

``ffi-undeclared``
    An export with no declaration (undeclared, ctypes assumes ``int``:
    a pointer truncates), or a ``_declare`` with no declarations at all
    (a checker that reads nothing must not pass).

``ffi-unknown-symbol``
    A declaration of a symbol no source exports.

``ffi-arity``
    ``len(argtypes)`` differs from the C parameter count.

``ffi-restype``
    The restype disagrees with the C return type.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from crowdllama_tpu_torch.analysis.base import Finding, dotted_name

CHECKER = "ffi-contract"

CPP_DIR = "crowdllama_tpu_torch/native/_src"
PY_DECL = "crowdllama_tpu_torch/native/__init__.py"

# C return type -> the ctypes restypes that match it (None: None).
_RETURN_MAP: dict[str, tuple[str | None, ...]] = {
    "void": (None,),
    "void*": ("c_void_p",),
    "long": ("c_long",),
    "int": ("c_int",),
    "int32_t": ("c_int32",),
    "int64_t": ("c_int64", "c_longlong"),
    "uint32_t": ("c_uint32",),
    "uint64_t": ("c_uint64", "c_ulonglong"),
    "size_t": ("c_size_t",),
    "double": ("c_double",),
    "float": ("c_float",),
}

# A function definition in an extern "C" block:  ret name(params) {
_FUNC_RE = re.compile(
    r"^[ \t]*([A-Za-z_][A-Za-z0-9_]*(?:\s*\*)?)\s+"   # return type
    r"(cl_[a-z0-9_]+)\s*\(([^)]*)\)\s*\{",            # name(params) {
    re.MULTILINE | re.DOTALL)


def _extern_c_blocks(text: str) -> list[tuple[int, str]]:
    """(start line, body) of every ``extern "C" { ... }`` block."""
    out: list[tuple[int, str]] = []
    for m in re.finditer(r'extern\s+"C"\s*\{', text):
        depth = 1
        i = m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        out.append((text.count("\n", 0, m.start()) + 1, text[m.end():i - 1]))
    return out


def _param_count(params: str) -> int:
    flat = " ".join(params.split())
    if not flat or flat == "void":
        return 0
    return flat.count(",") + 1  # no function-pointer parameters here


def c_exports(root: str) -> dict[str, tuple[str, int, str, int]]:
    """symbol -> (return type, parameter count, rel path, line)."""
    out: dict[str, tuple[str, int, str, int]] = {}
    d = Path(root) / CPP_DIR
    for f in sorted(d.glob("*.cpp")) if d.is_dir() else []:
        text = f.read_text(encoding="utf-8")
        rel = f.relative_to(root).as_posix()
        for start_line, body in _extern_c_blocks(text):
            for m in _FUNC_RE.finditer(body):
                ret = "".join(m.group(1).split())  # "void *" -> "void*"
                line = start_line + body.count("\n", 0, m.start())
                out[m.group(2)] = (ret, _param_count(m.group(3)), rel, line)
    return out


def _aliases(fn: ast.FunctionDef) -> dict[str, str]:
    """Local name -> the dotted name it stands for (``sz, vp = a.b, c.d``
    and ``u8p = ctypes.POINTER(...)``)."""
    out: dict[str, str] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs = (zip(tgt.elts, val.elts)
                 if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                 and len(tgt.elts) == len(val.elts) else [(tgt, val)])
        for t, v in pairs:
            if not isinstance(t, ast.Name):
                continue
            name = dotted_name(v.func if isinstance(v, ast.Call) else v)
            if name:
                out[t.id] = name
    return out


def _restype(node: ast.AST, aliases: dict[str, str]):
    if isinstance(node, ast.Constant) and node.value is None:
        return None
    if isinstance(node, ast.Call):
        return "<expr>"
    name = dotted_name(node)
    name = aliases.get(name, name)
    return name.rsplit(".", 1)[-1] if name else "<expr>"


def _applies(fn: ast.FunctionDef) -> bool:
    """True when ``_declare`` sets both halves on the library's
    functions (``x.restype = ...`` and ``x.argtypes = ...``)."""
    set_attrs = {t.attr for node in ast.walk(fn)
                 if isinstance(node, ast.Assign) for t in node.targets
                 if isinstance(t, ast.Attribute)}
    return {"restype", "argtypes"} <= set_attrs


def py_declarations(root: str) -> dict[str, dict]:
    """symbol -> {"restype": tail | None | "<expr>", "argc": int | None,
    "line": int} from the ``sigs`` dict of ``_declare`` (empty when
    there is no such dict, or ``_declare`` never applies it)."""
    path = Path(root) / PY_DECL
    if not path.is_file():
        return {}
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name == "_declare"),
              None)
    if fn is None or not _applies(fn):
        return {}
    aliases = _aliases(fn)
    decls: dict[str, dict] = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and isinstance(node.value,
                                                            ast.Dict)):
            continue
        for key, val in zip(node.value.keys, node.value.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            e = {"restype": "<expr>", "argc": None, "line": key.lineno}
            if isinstance(val, ast.Tuple) and len(val.elts) == 2:
                e["restype"] = _restype(val.elts[0], aliases)
                if isinstance(val.elts[1], (ast.List, ast.Tuple)):
                    e["argc"] = len(val.elts[1].elts)
            decls[key.value] = e
    return decls


def check_ffi_contract(root: str) -> list[Finding]:
    out: list[Finding] = []
    exports = c_exports(root)
    decls = py_declarations(root)
    if not decls:
        out.append(Finding(
            CHECKER, "ffi-undeclared", PY_DECL, 0, "_declare",
            "found no ctypes declarations (a `sigs` dict of name: "
            "(restype, [argtypes]) applied in _declare): nothing of the "
            "seam is checked"))
    if not exports:
        out.append(Finding(
            CHECKER, "ffi-undeclared", CPP_DIR, 0, "extern \"C\"",
            "found no extern \"C\" functions in the native sources"))
    for sym, (ret, argc, cpath, cline) in sorted(exports.items()):
        d = decls.get(sym)
        if d is None:
            out.append(Finding(
                CHECKER, "ffi-undeclared", PY_DECL, 0, sym,
                f"extern \"C\" `{sym}` ({cpath}:{cline}) has no ctypes "
                "declaration in _declare: its restype defaults to int "
                "(pointer truncation)"))
            continue
        if d["argc"] is None:
            out.append(Finding(
                CHECKER, "ffi-undeclared", PY_DECL, d["line"], sym,
                f"`{sym}` is not declared as (restype, [argtypes])"))
            continue
        if d["argc"] != argc:
            out.append(Finding(
                CHECKER, "ffi-arity", PY_DECL, d["line"], sym,
                f"argtypes declares {d['argc']} parameters but "
                f"`{sym}` ({cpath}:{cline}) takes {argc}: a mismatched "
                "arity passes stack garbage"))
        expected = _RETURN_MAP.get(ret)
        if expected is None:
            out.append(Finding(
                CHECKER, "ffi-restype", cpath, cline, sym,
                f"`{sym}` returns `{ret}`, which has no ctypes mapping in "
                "analysis/ffi_contract.py's _RETURN_MAP"))
        elif d["restype"] == "<expr>":
            out.append(Finding(
                CHECKER, "ffi-restype", PY_DECL, d["line"], sym,
                f"`{sym}` restype is a computed expression: declare a "
                "ctypes type (or an alias of one)"))
        elif d["restype"] not in expected:
            want = " or ".join("None" if e is None else f"ctypes.{e}"
                               for e in expected)
            got = "None" if d["restype"] is None else d["restype"]
            out.append(Finding(
                CHECKER, "ffi-restype", PY_DECL, d["line"], sym,
                f"`{sym}` returns `{ret}` in C but restype is {got}: "
                f"expected {want}"))
    for sym, d in sorted(decls.items()):
        if sym not in exports:
            out.append(Finding(
                CHECKER, "ffi-unknown-symbol", PY_DECL, d["line"], sym,
                f"_declare configures `{sym}` but no extern \"C\" "
                "function of that name exists in the native sources"))
    return out
