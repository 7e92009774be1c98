"""torch-purity checker: no host sync in the decode loop.

Counterpart of ``crowdllama_tpu/analysis/jax_purity.py``'s
``host-sync-in-decode-loop`` rule (the port has no traced code, so the
JAX package's other purity rules have nothing to read).  Over the port's
``engine``, ``ops``, ``parallel`` and ``train`` it flags:

``host-sync-in-decode-loop``
    A ``for``/``while`` loop that both dispatches decode work
    (``decode_steps_device``, ``decode_megastep``, ``ragged_step``,
    ``ragged_megastep``, ``decode_steps``) and waits on the device:
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize``, or ``np.asarray`` / ``np.array`` of
    anything but a literal display (a list, tuple, comprehension: host
    data).  A loop's scope is its own body and, transitively, the
    bodies of the methods of its class it calls through ``self``, so
    the scheduler's ``while True: await self._loop_once()`` is read
    through every method one iteration runs.  A per-step read-back
    there serializes host and device, and forfeits what the megastep's
    CUDA graphs won back: a flight is read back once, tokens and
    done-flags together.

The one sanctioned sync is that read-back: in the method that retires a
flight (``_retire_inflight``), the function handed to the dispatch
thread (a lambda passed to ``_run`` or ``run_in_executor``).
"""

from __future__ import annotations

import ast

from crowdllama_tpu_torch.analysis.base import (
    Finding,
    SourceFile,
    dotted_name,
    load_sources,
)

CHECKER = "torch-purity"

SUBDIRS = ("engine", "ops", "parallel", "train")

_DISPATCH_CALLS = frozenset({
    "decode_steps_device", "decode_megastep", "ragged_step",
    "ragged_megastep", "decode_steps",
})
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_NAMES = frozenset({"torch.cuda.synchronize"})
_ARRAY_NAMES = frozenset({"np.asarray", "np.array", "numpy.asarray",
                          "numpy.array"})
_HOST_DISPLAYS = (ast.List, ast.Tuple, ast.Set, ast.ListComp, ast.SetComp,
                  ast.GeneratorExp)
# Where a flight is read back, and the calls that hand a function to the
# dispatch thread.
RETIRE_METHODS = frozenset({"_retire_inflight"})
_EXECUTOR_CALLS = frozenset({"_run", "run_in_executor"})


def _sanctioned(fn: ast.AST) -> set[int]:
    """ids of the nodes of a retire method's read-back lambdas."""
    out: set[int] = set()
    if getattr(fn, "name", "") not in RETIRE_METHODS:
        return out
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in _EXECUTOR_CALLS):
            for arg in node.args:
                if isinstance(arg, ast.Lambda):
                    out |= {id(n) for n in ast.walk(arg)}
    return out


def _syncs(node: ast.AST, skip: set[int]) -> list[tuple[int, str]]:
    out = []
    for sub in ast.walk(node):
        if id(sub) in skip:
            continue
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _SYNC_ATTRS):
            out.append((sub.lineno, f".{sub.func.attr}()"))
        elif isinstance(sub, ast.Attribute) and dotted_name(sub) in _SYNC_NAMES:
            out.append((sub.lineno, dotted_name(sub)))
        elif (isinstance(sub, ast.Call) and dotted_name(sub.func)
              in _ARRAY_NAMES and not (sub.args and isinstance(
                  sub.args[0], _HOST_DISPLAYS))):
            out.append((sub.lineno, dotted_name(sub.func)))
        elif (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
              and sub.func.attr in _EXECUTOR_CALLS):
            # A bare np.asarray handed to the dispatch thread.
            for arg in sub.args:
                if dotted_name(arg) in _ARRAY_NAMES:
                    out.append((arg.lineno, dotted_name(arg)))
    return out


def _dispatches(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _DISPATCH_CALLS:
            return True
        if isinstance(sub, ast.Name) and sub.id in _DISPATCH_CALLS:
            return True
    return False


def _self_calls(node: ast.AST) -> set[str]:
    return {sub.func.attr for sub in ast.walk(node)
            if isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == "self"}


def _scope(loop: ast.AST, methods: dict[str, ast.AST]) -> list[ast.AST]:
    """The loop and every method of its class it reaches through self."""
    scope, seen, todo = [loop], set(), set(_self_calls(loop))
    while todo:
        name = todo.pop()
        if name in seen or name not in methods:
            continue
        seen.add(name)
        scope.append(methods[name])
        todo |= _self_calls(methods[name])
    return scope


def _loop_sync_findings(src: SourceFile) -> list[Finding]:
    """One finding per (function, first sync line)."""
    out: list[Finding] = []
    seen: set[tuple[str, int]] = set()

    def visit(node: ast.AST, fname: str, methods: dict) -> None:
        if isinstance(node, ast.ClassDef):
            methods = {f.name: f for f in node.body
                       if isinstance(f, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fname = node.name
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            scope = _scope(node, methods)
            if any(_dispatches(n) for n in scope):
                syncs = []
                for n in scope:
                    syncs += _syncs(n, _sanctioned(n))
                if syncs:
                    line, what = min(syncs)
                    if (fname, line) not in seen:
                        seen.add((fname, line))
                        out.append(Finding(
                            CHECKER, "host-sync-in-decode-loop", src.path,
                            line, fname,
                            f"`{what}` in the same loop as a decode "
                            "dispatch serializes host and device per step: "
                            "read a flight back once, in its retire"))
        for child in ast.iter_child_nodes(node):
            visit(child, fname, methods)

    visit(src.tree, "<module>", {})
    return out


def check_torch_purity(root: str,
                       subdirs: tuple[str, ...] = SUBDIRS) -> list[Finding]:
    out: list[Finding] = []
    for src in load_sources(root, subdirs):
        out.extend(_loop_sync_findings(src))
    return out
