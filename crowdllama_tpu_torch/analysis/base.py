"""Shared plumbing of the port's static analysis: findings, source
loading, the baseline of waivers.

Counterpart of ``crowdllama_tpu/analysis/base.py``, rooted at
``crowdllama_tpu_torch/``.  A :class:`Finding` is keyed by ``(checker,
path, code, symbol)``: its line is shown but kept out of the waiver key,
so a waiver survives edits above it.  The baseline is a TOML subset
(``[[waiver]]`` tables of string keys) parsed here.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from pathlib import Path

#: the package every checker reads
PACKAGE = "crowdllama_tpu_torch"


@dataclass(frozen=True)
class Finding:
    checker: str   # the checker's name, e.g. "ffi-contract"
    code: str      # the rule within the checker, e.g. "blocking-call"
    path: str      # repo-relative posix path
    line: int      # 1-based; 0 for a whole-file or contract finding
    symbol: str    # enclosing function or contract key: the stable anchor
    message: str

    def key(self) -> tuple[str, str, str, str]:
        return (self.checker, self.path, self.code, self.symbol)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.checker}/{self.code}] {self.symbol}: " \
               f"{self.message}"

    def as_json(self) -> dict:
        return {"checker": self.checker, "code": self.code,
                "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message}


def repo_root() -> str:
    """The directory holding the ``crowdllama_tpu_torch`` package."""
    return str(Path(__file__).resolve().parents[2])


@dataclass
class SourceFile:
    path: str       # repo-relative posix
    text: str
    tree: ast.Module


def load_sources(root: str, subdirs: tuple[str, ...]) -> list[SourceFile]:
    """Parse every .py under ``crowdllama_tpu_torch/<subdir>`` (or a
    subdir that is a .py file).  A file that does not parse raises."""
    out: list[SourceFile] = []
    base = Path(root)
    for sub in subdirs:
        p = base / PACKAGE / sub
        files = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
        for f in files:
            if not f.is_file():
                continue
            text = f.read_text(encoding="utf-8")
            rel = f.relative_to(base).as_posix()
            out.append(SourceFile(rel, text, ast.parse(text, filename=rel)))
    return out


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, "" for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclass
class Baseline:
    """Committed waivers.  ``waives`` consumes; ``stale`` lists entries
    that matched nothing this run."""

    entries: list[dict] = field(default_factory=list)
    _hit: set[int] = field(default_factory=set)

    def waives(self, f: Finding) -> bool:
        for i, e in enumerate(self.entries):
            if (e.get("checker") == f.checker and e.get("code") == f.code
                    and e.get("path") == f.path
                    and e.get("symbol") == f.symbol):
                self._hit.add(i)
                return True
        return False

    def stale(self) -> list[dict]:
        return [e for i, e in enumerate(self.entries) if i not in self._hit]


_KV_RE = re.compile(r'^([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def parse_baseline_toml(text: str) -> list[dict]:
    """Parse ``[[waiver]]`` tables of string keys; every waiver needs a
    checker, code, path, symbol and a non-empty reason."""
    entries: list[dict] = []
    current: dict | None = None
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[waiver]]":
            current = {}
            entries.append(current)
            continue
        m = _KV_RE.match(line)
        if m is None or current is None:
            raise ValueError(f"baseline.toml:{ln}: unparseable line {raw!r} "
                             "(only [[waiver]] tables of string keys)")
        current[m.group(1)] = m.group(2).replace('\\"', '"')
    for e in entries:
        missing = {"checker", "code", "path", "symbol", "reason"} - set(e)
        if missing:
            raise ValueError(f"baseline.toml: waiver {e} missing keys "
                             f"{sorted(missing)}: every waiver needs a "
                             "justification in `reason`")
        if not e["reason"].strip():
            raise ValueError(f"baseline.toml: waiver {e} has an empty "
                             "reason: justify it or fix the finding")
    return entries


def load_baseline(path: str | None = None) -> Baseline:
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "baseline.toml")
    if not os.path.exists(path):
        return Baseline()
    return Baseline(parse_baseline_toml(
        Path(path).read_text(encoding="utf-8")))
