"""async-hotpath checker: the port's asyncio request plane must not block.

Counterpart of ``crowdllama_tpu/analysis/async_hotpath.py`` with the same
rules, over the port's request plane (``gateway``, ``peer``,
``peermanager``, ``net``, ``swarm``, ``obs`` and ``ipc``).  It walks
every ``async def`` and flags:

``blocking-call``
    Synchronous calls that stall the event loop: ``time.sleep``, the
    ``subprocess.run`` family, sync socket and DNS helpers, sync file IO
    through ``open(...)``, ``shutil.rmtree``; and ``.result()`` on a
    future (``blocking-result``).  Bodies of nested sync functions and
    lambdas are exempt: that is the ``run_in_executor`` idiom.

``unawaited-coroutine``
    A bare expression statement calling a function every definition of
    which in the package is ``async def``: the coroutine is made and
    dropped, so the work never runs.  Calls wrapped in ``create_task``,
    ``ensure_future`` or ``gather`` are fine; a name with a sync
    definition anywhere is skipped.

``unlocked-mutation``
    Per class: an attribute mutated under ``async with self.<lock>`` in
    one coroutine method and outside it in another.  The guard relation
    comes from the code itself.
"""

from __future__ import annotations

import ast

from crowdllama_tpu_torch.analysis.base import (
    Finding,
    SourceFile,
    dotted_name,
    load_sources,
)

CHECKER = "async-hotpath"

SUBDIRS = ("gateway", "peer", "peermanager", "net", "swarm", "obs", "ipc")

# Dotted-name suffixes that block the loop when called from a coroutine.
BLOCKING_CALLS = frozenset({
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
    "os.system", "os.wait", "os.waitpid",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname",
    "urllib.request.urlopen",
    "requests.get", "requests.post", "requests.request",
    "shutil.rmtree", "shutil.copytree",
})

# Wrappers that consume a coroutine object.
_TASK_WRAPPERS = frozenset({
    "create_task", "ensure_future", "gather", "wait", "wait_for",
    "run_coroutine_threadsafe", "shield", "run", "as_completed",
})


def collect_async_defs(sources: list[SourceFile]) -> dict[str, list[bool]]:
    """Function name -> [is_async per definition] across the package."""
    defs: dict[str, list[bool]] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(
                    isinstance(node, ast.AsyncFunctionDef))
    return defs


def _iter_async_body(fn: ast.AsyncFunctionDef):
    """The coroutine's own nodes: nested defs and lambdas are skipped
    (executor bodies, or coroutines the outer walk visits itself)."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _blocking_findings(src: SourceFile, fn: ast.AsyncFunctionDef,
                       qual: str) -> list[Finding]:
    out: list[Finding] = []
    for node in _iter_async_body(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name and any(name == b or name.endswith("." + b)
                        for b in BLOCKING_CALLS):
            out.append(Finding(
                CHECKER, "blocking-call", src.path, node.lineno, qual,
                f"`{name}(...)` blocks the event loop; await an async "
                "equivalent or push it through run_in_executor"))
        elif name == "open":
            out.append(Finding(
                CHECKER, "blocking-call", src.path, node.lineno, qual,
                "sync file IO `open(...)` on the event loop; use "
                "run_in_executor"))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr == "result" and not node.args
              and not node.keywords):
            out.append(Finding(
                CHECKER, "blocking-result", src.path, node.lineno, qual,
                "`.result()` on a future blocks (or raises "
                "InvalidStateError): await it instead"))
    return out


def _unawaited_findings(src: SourceFile, fn: ast.AsyncFunctionDef,
                        qual: str,
                        async_only: frozenset[str]) -> list[Finding]:
    out: list[Finding] = []
    for node in _iter_async_body(fn):
        if not (isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)):
            continue
        func = node.value.func
        callee = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if callee in async_only and callee not in _TASK_WRAPPERS:
            out.append(Finding(
                CHECKER, "unawaited-coroutine", src.path, node.lineno, qual,
                f"call to coroutine `{callee}` is neither awaited nor "
                "wrapped in create_task: the work never runs"))
    return out


class _ClassLocks:
    """Per class: the self attributes holding asyncio locks, the locks
    each attribute was mutated under, and every mutation site."""

    def __init__(self) -> None:
        self.locks: set[str] = set()
        self.guarded: dict[str, set[str]] = {}  # attr -> lock names
        # (attr, line, qualname, locks held there)
        self.mutations: list[tuple[str, int, str, frozenset[str]]] = []


def _self_attr(node: ast.AST) -> str:
    """'x' for a bare ``self.x``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return ""


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    locks: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value_name = dotted_name(node.value.func) \
            if isinstance(node.value, ast.Call) else ""
        if value_name.endswith("asyncio.Lock") or value_name == "Lock":
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr:
                    locks.add(attr)
    return locks


def _mutated_attr(stmt: ast.AST) -> list[str]:
    """Self attributes a statement assigns (plainly or augmented)."""
    out = []
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            a = _self_attr(tgt)
            if a:
                out.append(a)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        a = _self_attr(stmt.target)
        if a:
            out.append(a)
    return out


def _walk_with_locks(body, held: frozenset[str], qual: str,
                     info: _ClassLocks) -> None:
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        for attr in _mutated_attr(stmt):
            if attr in info.locks:
                continue  # the lock itself being made
            info.mutations.append((attr, stmt.lineno, qual, held))
            for lk in held:
                info.guarded.setdefault(attr, set()).add(lk)
        if isinstance(stmt, ast.AsyncWith):
            new = set(held)
            for item in stmt.items:
                lk = _self_attr(item.context_expr)
                if lk in info.locks:
                    new.add(lk)
            _walk_with_locks(stmt.body, frozenset(new), qual, info)
            continue
        for field_body in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, field_body, None)
            if not sub:
                continue
            if field_body == "handlers":
                for h in sub:
                    _walk_with_locks(h.body, held, qual, info)
            else:
                _walk_with_locks(sub, held, qual, info)


def _unlocked_findings(src: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for cls in ast.walk(src.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        info = _ClassLocks()
        info.locks = _lock_attrs(cls)
        if not info.locks:
            continue
        for fn in cls.body:
            if isinstance(fn, ast.AsyncFunctionDef):
                _walk_with_locks(fn.body, frozenset(),
                                 f"{cls.name}.{fn.name}", info)
        for attr, line, qual, held in info.mutations:
            needed = info.guarded.get(attr, set())
            if needed and not (held & needed):
                out.append(Finding(
                    CHECKER, "unlocked-mutation", src.path, line, qual,
                    f"`self.{attr}` is mutated under `async with "
                    f"self.{sorted(needed)[0]}` elsewhere in {cls.name} "
                    "but not here: racy across awaits"))
    return out


def check_async_hotpath(root: str,
                        subdirs: tuple[str, ...] = SUBDIRS) -> list[Finding]:
    sources = load_sources(root, subdirs)
    # The async-only names span the whole package, so a coroutine of the
    # engine dropped in peer code is seen.
    defs = collect_async_defs(load_sources(root, ("",)))
    async_only = frozenset(
        name for name, kinds in defs.items() if all(kinds))
    out: list[Finding] = []
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            out.extend(_blocking_findings(src, node, node.name))
            out.extend(_unawaited_findings(src, node, node.name,
                                           async_only))
        out.extend(_unlocked_findings(src))
    return out
