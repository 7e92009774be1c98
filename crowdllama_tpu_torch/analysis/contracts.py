"""contract-exhaustiveness checker: string-keyed cross-node contracts.

Counterpart of ``crowdllama_tpu/analysis/contracts.py``: the same four
sub-checkers and finding codes, over the port's tree.  Each reads its
source of truth from the artifact itself, never from a hand-copied list:

``oneof-*``
    The llama.v1 ``BaseMessage.message`` oneof, read from the port's own
    codec table (``core/llama_v1.py BaseMessage._ONEOFS``; the port has
    no compiled descriptor) against ``core/messages.py`` constructors
    and extractors and the ``peer/peer.py`` serve dispatch.

``fault-site-*``
    ``testing/faults.py``'s FAULT_SITES registry against the
    ``faults.inject("<site>")`` call sites of the port's code, both
    ways, and the sites the port's tests (``tests/test_torch_*.py``)
    build FaultRules from.  The JAX package's tests build the JAX
    package's rules, so they are not read here.

``metrics-*``
    Every ``crowdllama_*`` family named in the port's code is documented
    in ``docs/OBSERVABILITY.md`` (the exact name, or a documented family
    prefix), and every documented family is still emitted.

``config-*``
    CLI-flag/env parity in ``config.py``: every Configuration field is
    settable from the environment, every registered flag dest is a real
    field, and every dest is consumed by ``from_flags``.  The port's
    ``from_environment`` loops over the class table ``_ENV`` (field ->
    variable) instead of assigning ``cfg.<field>`` one by one, and
    ``from_flags`` over ``_FLAG_FIELDS``: the strings of a class table a
    method reads count as what it sets or consumes, beside its direct
    ``cfg.<field>`` assignments (such as ``verbose``) and string
    literals.

:func:`check_contracts` runs the four, each over the files it reads; a
missing file (a moved or renamed anchor) raises instead of passing
unchecked.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from crowdllama_tpu_torch.analysis.base import (
    PACKAGE,
    Finding,
    dotted_name,
    load_sources,
)

CHECKER = "contracts"

MESSAGES = f"{PACKAGE}/core/messages.py"
PEER = f"{PACKAGE}/peer/peer.py"
FAULTS = f"{PACKAGE}/testing/faults.py"
CONFIG = f"{PACKAGE}/config.py"
DOC = "docs/OBSERVABILITY.md"

# Oneof arms that are responses on the wire (worker/donor -> caller).
# They need constructors + extractors but no serve-dispatch arm; a NEW
# arm that is neither dispatched in peer.py nor added here fails lint.
RESPONSE_ARMS = frozenset({
    "generate_response", "embed_response", "kv_pages", "migrate_frame",
    "trace_spans", "metrics_snapshot", "verify_result",
})

# Configuration fields intentionally without a CROWDLLAMA_TPU_* env read.
CONFIG_ENV_EXEMPT = frozenset({
    "intervals",  # derived wholesale from CROWDLLAMA_TPU_TEST_MODE
})

_FAMILY_RE = re.compile(r"crowdllama_[a-z0-9_]+")
# Tokens that look like families but are package/protocol identifiers.
# `crowdllama_native` alone is the shared-library name (the real
# crowdllama_native_* families are longer and stay doc-checked);
# `crowdllama_manifest` is the checkpoint-cache integrity dotfile
# (net/model_share.py MANIFEST_NAME); `crowdllama_engine` alone is the
# prefix a golden metrics_fetch frame asks for (core/wire_golden.py), a
# request argument, not an exposition family.
_FAMILY_JUNK_PREFIXES = ("crowdllama_tpu",)
_FAMILY_JUNK_EXACT = frozenset({"crowdllama_native", "crowdllama_manifest",
                                "crowdllama_engine"})


def _read(root: str, rel: str) -> str:
    return (Path(root) / rel).read_text(encoding="utf-8")


# ---------------------------------------------------------------- oneof

def _oneof_arms() -> list[str]:
    from crowdllama_tpu_torch.core import llama_v1 as pb

    return list(pb.BaseMessage._ONEOFS["message"])


def check_oneof(root: str) -> list[Finding]:
    out: list[Finding] = []
    messages_src = _read(root, MESSAGES)
    peer_src = _read(root, PEER)
    for arm in _oneof_arms():
        if f"{arm}=" not in messages_src:
            out.append(Finding(
                CHECKER, "oneof-constructor", MESSAGES, 0, arm,
                f"oneof arm `{arm}` has no BaseMessage({arm}=...) "
                "constructor in core/messages.py"))
        if f'"{arm}"' not in messages_src:
            out.append(Finding(
                CHECKER, "oneof-extractor", MESSAGES, 0, arm,
                f"oneof arm `{arm}` has no WhichOneof-guarded extractor "
                "in core/messages.py"))
        if arm in RESPONSE_ARMS:
            continue
        dispatched = (f'which == "{arm}"' in peer_src
                      or f'which != "{arm}"' in peer_src)
        if not dispatched:
            out.append(Finding(
                CHECKER, "oneof-dispatch", PEER, 0, arm,
                f"request arm `{arm}` is not handled by the peer serve "
                "dispatch — wire it, or declare it a response arm in "
                "analysis/contracts.py RESPONSE_ARMS"))
    return out


# ---------------------------------------------------------- fault sites

def _inject_sites(root: str) -> dict[str, str]:
    """site literal -> 'path:line' for every faults.inject("<lit>") in the
    port's code (the faults module and the analysis excluded)."""
    sites: dict[str, str] = {}
    for src in load_sources(root, ("",)):
        if src.path == FAULTS \
                or src.path.startswith(f"{PACKAGE}/analysis/"):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if not (name == "inject" or name.endswith(".inject")):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                sites[node.args[0].value] = f"{src.path}:{node.lineno}"
    return sites


def _test_rule_sites(root: str) -> dict[str, str]:
    """site literal -> 'path:line' for every FaultRule(site="<lit>") in
    ``tests/test_torch_*.py``."""
    sites: dict[str, str] = {}
    d = Path(root) / "tests"
    if not d.is_dir():
        return sites
    for f in sorted(d.glob("test_torch_*.py")):
        try:
            tree = ast.parse(f.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        rel = f.relative_to(root).as_posix()
        # Lines inside `with pytest.raises(...)` blocks hold DELIBERATE
        # bad-site fixtures (the registry's own tests); a rule built
        # there never reaches a plan.
        negative: list[tuple[int, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.With):
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and dotted_name(
                            ctx.func).endswith("raises"):
                        negative.append(
                            (node.lineno, node.end_lineno or node.lineno))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func).rsplit(".", 1)[-1] != "FaultRule":
                continue
            if any(a <= node.lineno <= b for a, b in negative):
                continue
            for kw in node.keywords:
                if kw.arg == "site" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    sites[kw.value.value] = f"{rel}:{node.lineno}"
    return sites


def check_fault_sites(root: str) -> list[Finding]:
    from crowdllama_tpu_torch.testing.faults import FAULT_SITES

    out: list[Finding] = []
    instrumented = _inject_sites(root)
    for site, where in instrumented.items():
        path, line = where.rsplit(":", 1)
        if site not in FAULT_SITES:
            out.append(Finding(
                CHECKER, "fault-site-unregistered", path, int(line), site,
                f"faults.inject site `{site}` is not in the FAULT_SITES "
                "registry (testing/faults.py) — register it with a "
                "one-line description"))
    for site in FAULT_SITES:
        if site not in instrumented:
            out.append(Finding(
                CHECKER, "fault-site-uninstrumented", FAULTS, 0, site,
                f"FAULT_SITES registers `{site}` but no faults.inject "
                "call uses it — dead registry entry"))
    for site, where in _test_rule_sites(root).items():
        path, line = where.rsplit(":", 1)
        if site not in FAULT_SITES:
            out.append(Finding(
                CHECKER, "fault-site-unknown-in-test", path, int(line), site,
                f"FaultRule(site=\"{site}\") names an unregistered site — "
                "the rule would never fire (FaultRule also rejects it at "
                "plan build)"))
    return out


# -------------------------------------------------------------- metrics

def _junk(token: str) -> bool:
    return token.startswith(_FAMILY_JUNK_PREFIXES) \
        or token in _FAMILY_JUNK_EXACT


def _histogram_base(token: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if token.endswith(suffix):
            return token[: -len(suffix)]
    return token


def collect_metric_families(root: str) -> tuple[set[str], set[str]]:
    """(exact family names, dynamic family prefixes) read from string
    literals and f-string constant parts across the port's package.

    ``_bucket``/``_sum``/``_count`` exposition suffixes collapse onto the
    histogram family; junk tokens (module paths, protocol arguments) are
    filtered."""
    exact: set[str] = set()
    prefixes: set[str] = set()

    def _add(token: str, dynamic_tail: bool) -> None:
        if _junk(token):
            return
        # A trailing-underscore token is a family-prefix fragment whether
        # it came from an f-string (f"crowdllama_engine_{key}") or a
        # regex/startswith literal: valid exposition names never end in
        # "_".
        if dynamic_tail or token.endswith("_"):
            if token.endswith("_"):
                prefixes.add(token)
            return
        exact.add(_histogram_base(token))

    for src in load_sources(root, ("",)):
        if src.path.startswith(f"{PACKAGE}/analysis/"):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for m in _FAMILY_RE.finditer(node.value):
                    _add(m.group(0), dynamic_tail=False)
            elif isinstance(node, ast.JoinedStr):
                for i, part in enumerate(node.values):
                    if not (isinstance(part, ast.Constant)
                            and isinstance(part.value, str)):
                        continue
                    for m in _FAMILY_RE.finditer(part.value):
                        # A match running to the end of a constant part
                        # followed by a {format} field is a dynamic
                        # family prefix, e.g. f"crowdllama_kv_ship_{k}".
                        at_end = m.end() == len(part.value)
                        has_field = i + 1 < len(node.values)
                        _add(m.group(0), dynamic_tail=at_end and has_field)
    return exact, prefixes


def check_metrics_docs(root: str) -> list[Finding]:
    doc_tokens = set(_FAMILY_RE.findall(_read(root, DOC)))
    doc_prefixes = {t for t in doc_tokens if t.endswith("_")}
    out: list[Finding] = []
    exact, prefixes = collect_metric_families(root)
    for fam in sorted(exact):
        if fam not in doc_tokens and not any(
                fam.startswith(p) for p in doc_prefixes):
            out.append(Finding(
                CHECKER, "metrics-undocumented", DOC, 0, fam,
                f"metric family `{fam}` is emitted in code but not "
                "documented in docs/OBSERVABILITY.md"))
    for pref in sorted(prefixes):
        if pref not in doc_tokens and not any(
                t.startswith(pref) for t in doc_tokens):
            out.append(Finding(
                CHECKER, "metrics-undocumented", DOC, 0, pref + "*",
                f"dynamic metric family `{pref}*` is emitted in code but "
                f"no `{pref}...` family appears in docs/OBSERVABILITY.md"))
    # Families documented but gone from the code: stale docs mislead.
    for tok in sorted(doc_tokens):
        if _junk(tok) or tok.endswith("_"):
            continue
        base = _histogram_base(tok)
        if base not in exact and not any(base.startswith(p)
                                         for p in prefixes):
            out.append(Finding(
                CHECKER, "metrics-stale-doc", DOC, 0, tok,
                f"docs/OBSERVABILITY.md documents `{tok}` but no code "
                "emits that family any more"))
    return out


# --------------------------------------------------------------- config

def _class_def(tree: ast.Module, name: str) -> ast.ClassDef:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    raise AssertionError(f"config.py: class {name} not found")


def _method(cls: ast.ClassDef, name: str) -> ast.FunctionDef:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise AssertionError(f"config.py: {cls.name}.{name} not found")


def _tables(cls: ast.ClassDef) -> dict[str, set[str]]:
    """The class-level literal tables: name -> the strings a dict's keys
    or a tuple's, list's or set's items hold."""
    out: dict[str, set[str]] = {}
    for node in cls.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        items = (v.keys if isinstance(v, ast.Dict) else v.elts
                 if isinstance(v, (ast.Tuple, ast.List, ast.Set)) else None)
        if items is not None:
            out[node.targets[0].id] = {
                k.value for k in items if isinstance(k, ast.Constant)
                and isinstance(k.value, str)}
    return out


def _read_tables(cls: ast.ClassDef, fn: ast.FunctionDef) -> set[str]:
    """The strings of every class table ``fn`` reads (``cls._ENV``)."""
    tables = _tables(cls)
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr in tables:
            out |= tables[node.attr]
    return out


def _env_fields(cls: ast.ClassDef) -> set[str]:
    """The fields ``from_environment`` sets: its ``cfg.<field> = ...``
    assignments, and the keys of the tables it reads (``_ENV``)."""
    from_env = _method(cls, "from_environment")
    assigned: set[str] = set()
    for node in ast.walk(from_env):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "cfg"):
                    assigned.add(tgt.attr)
    return assigned | _read_tables(cls, from_env)


def check_config_parity(root: str) -> list[Finding]:
    cls = _class_def(ast.parse(_read(root, CONFIG)), "Configuration")
    fields = [n.target.id for n in cls.body
              if isinstance(n, ast.AnnAssign)
              and isinstance(n.target, ast.Name)]
    env_assigned = _env_fields(cls)

    dests: dict[str, int] = {}
    for node in ast.walk(_method(cls, "add_flags")):
        if not (isinstance(node, ast.Call)
                and dotted_name(node.func).endswith("add_argument")):
            continue
        dest = ""
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = kw.value.value
        if not dest:
            for arg in node.args:
                if isinstance(arg, ast.Constant) \
                        and str(arg.value).startswith("--"):
                    dest = str(arg.value)[2:].replace("-", "_")
        if dest:
            dests[dest] = node.lineno

    from_flags = _method(cls, "from_flags")
    flags_consumed = {node.value for node in ast.walk(from_flags)
                      if isinstance(node, ast.Constant)
                      and isinstance(node.value, str)}
    flags_consumed |= _read_tables(cls, from_flags)

    out: list[Finding] = []
    for f in fields:
        if f not in CONFIG_ENV_EXEMPT and f not in env_assigned:
            out.append(Finding(
                CHECKER, "config-no-env", CONFIG, 0, f,
                f"Configuration.{f} cannot be set from the environment — "
                "add it to Configuration._ENV (env/flag parity keeps "
                "container deploys scriptable)"))
    for dest, line in dests.items():
        if dest not in fields:
            out.append(Finding(
                CHECKER, "config-unknown-dest", CONFIG, line, dest,
                f"flag dest `{dest}` is not a Configuration field — the "
                "flag parses and is silently dropped"))
        elif dest not in flags_consumed:
            out.append(Finding(
                CHECKER, "config-flag-unconsumed", CONFIG, line, dest,
                f"flag dest `{dest}` is registered in add_flags but "
                "never read by from_flags — the flag parses and is "
                "silently dropped"))
    return out


def check_contracts(root: str) -> list[Finding]:
    out: list[Finding] = []
    out.extend(check_oneof(root))
    out.extend(check_fault_sites(root))
    out.extend(check_metrics_docs(root))
    out.extend(check_config_parity(root))
    return out
