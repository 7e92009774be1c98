"""The port's static analysis (``crowdllama_tpu_torch/analysis/``): the
port's tree is clean under all three checkers within the 30 s budget
with zero waivers; each rule fires on a seeded violation and stays quiet
on the idiom it must allow; ``async_hotpath`` finds what the JAX
package's checker finds on the same source laid out under either
package; the FFI checker reads all 17 declarations of
``native/__init__.py`` and reports each of its four rules on a drifted
copy; the CLI's exit codes and JSON."""

import json
import shutil
import textwrap
import time
from pathlib import Path

import pytest

from crowdllama_tpu.analysis.async_hotpath import (
    check_async_hotpath as jax_async_hotpath,
)
from crowdllama_tpu_torch.analysis import load_baseline, repo_root, run_all
from crowdllama_tpu_torch.analysis import torch_purity
from crowdllama_tpu_torch.analysis.__main__ import main as cli_main
from crowdllama_tpu_torch.analysis.async_hotpath import check_async_hotpath
from crowdllama_tpu_torch.analysis.base import (
    Baseline,
    Finding,
    parse_baseline_toml,
)
from crowdllama_tpu_torch.analysis.ffi_contract import (
    PY_DECL,
    c_exports,
    check_ffi_contract,
    py_declarations,
)

ROOT = Path(repo_root())


def _fake_repo(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text), encoding="utf-8")
    return str(tmp_path)


# ------------------------------------------------------------- the tree


def test_the_port_is_clean_within_budget_with_zero_waivers():
    baseline = load_baseline()
    t0 = time.perf_counter()
    findings = run_all(repo_root(), baseline)
    elapsed = time.perf_counter() - t0
    assert not findings, "\n".join(f.render() for f in findings)
    assert baseline.entries == []
    assert elapsed < 30.0, f"analysis took {elapsed:.1f}s"


def test_baseline_parser_and_waivers():
    good = parse_baseline_toml(
        '# c\n[[waiver]]\nchecker = "async-hotpath"\ncode = "blocking-call"'
        '\npath = "crowdllama_tpu_torch/x.py"\nsymbol = "f"\n'
        'reason = "startup-only read"\n')
    assert good[0]["symbol"] == "f"
    with pytest.raises(ValueError, match="missing keys"):
        parse_baseline_toml('[[waiver]]\nchecker = "x"\n')
    with pytest.raises(ValueError, match="empty"):
        parse_baseline_toml('[[waiver]]\nchecker = "c"\ncode = "k"\n'
                            'path = "p"\nsymbol = "s"\nreason = " "\n')
    with pytest.raises(ValueError, match="unparseable"):
        parse_baseline_toml("checker = 3\n")
    b = Baseline(entries=[
        {"checker": "c", "code": "k", "path": "p.py", "symbol": "f",
         "reason": "r"},
        {"checker": "c", "code": "k", "path": "o.py", "symbol": "g",
         "reason": "r"}])
    assert b.waives(Finding("c", "k", "p.py", 42, "f", "m"))
    assert b.waives(Finding("c", "k", "p.py", 142, "f", "m"))  # line moved
    assert not b.waives(Finding("c", "k", "p.py", 42, "h", "m"))
    assert [e["path"] for e in b.stale()] == ["o.py"]


# -------------------------------------------------------- async-hotpath

ASYNC_FIXTURE = """
    import asyncio
    import shutil
    import time


    class Manager:
        def __init__(self):
            self._lock = asyncio.Lock()
            self.table = {}

        async def locked_update(self, k, v):
            async with self._lock:
                self.table = {k: v}

        async def racy_update(self):
            self.table = {}

        async def also_locked(self):
            async with self._lock:
                self.table = {}


    async def do_work():
        await asyncio.sleep(0)


    async def bad_sleep():
        time.sleep(0.1)


    async def bad_rmtree(path):
        shutil.rmtree(path)


    async def bad_open(path):
        with open(path) as f:
            return f.read()


    async def bad_result(fut):
        return fut.result()


    async def lost():
        do_work()


    async def fine(loop, path, fut):
        await asyncio.sleep(0.1)
        await loop.run_in_executor(None, lambda: time.sleep(1))

        def reader():
            with open(path) as f:
                return f.read()

        await asyncio.to_thread(reader)
        asyncio.get_running_loop().create_task(do_work())
        await asyncio.gather(do_work(), do_work())
        return await fut
"""


@pytest.mark.parametrize("sub", ["gateway", "ipc"])
def test_async_rules_fire_on_seeds_and_equal_the_jax_checker(tmp_path, sub):
    port = check_async_hotpath(_fake_repo(tmp_path / "t", {
        f"crowdllama_tpu_torch/{sub}/mod.py": ASYNC_FIXTURE}))
    got = sorted((f.code, f.line, f.symbol) for f in port)
    assert {(c, s) for c, _, s in got} == {
        ("unlocked-mutation", "Manager.racy_update"),
        ("blocking-call", "bad_sleep"), ("blocking-call", "bad_rmtree"),
        ("blocking-call", "bad_open"), ("blocking-result", "bad_result"),
        ("unawaited-coroutine", "lost")}
    assert not [f for f in port if f.symbol == "fine"]
    if sub == "ipc":  # the JAX checker does not read ipc/
        return
    jax = jax_async_hotpath(_fake_repo(tmp_path / "j", {
        f"crowdllama_tpu/{sub}/mod.py": ASYNC_FIXTURE}))
    assert sorted((f.code, f.line, f.symbol) for f in jax) == got


# --------------------------------------------------------- torch-purity

PURITY_SEEDS = """
    import numpy as np
    import torch


    def per_step_item(runner, state):
        out = []
        for _ in range(8):
            tokens, state = runner.decode_steps_device(state, 1)
            out.append(tokens[0, 0].item())
        return out


    def per_step_asarray(runner, state, loop, ex):
        while True:
            tokens, state = runner.decode_megastep(state, 4)
            loop.run_in_executor(ex, np.asarray, tokens)


    def per_step_sync(runner, state, job):
        while not job.finished:
            _, state = runner.ragged_step(state, job, 1)
            torch.cuda.synchronize()


    class Loop:
        async def _loop(self):
            while True:
                await self._once()

        async def _once(self):
            self.fl = self.runner.decode_megastep(self.state, 8)
            await self._read()

        async def _read(self):
            return self.fl.cpu().numpy()
"""

PURITY_NEGATIVES = """
    import numpy as np
    import torch


    def host_data_only(runner, state, slots):
        for _ in range(8):
            _, state = runner.decode_steps(state, 1)
            eos = np.array([s.eos for s in slots], np.int32)
            keys = np.asarray([1, 2])
        return eos, keys


    def syncs_without_dispatch(xs):
        return [x.cpu().numpy() for x in xs] + [x.item() for x in xs]


    def read_after_the_loop(runner, state):
        for _ in range(4):
            tokens, state = runner.decode_steps_device(state, 1)
        torch.cuda.synchronize()
        return tokens.cpu()


    class Scheduler:
        async def _loop(self):
            while True:
                await self._loop_once()

        async def _loop_once(self):
            self.flight = self.runner.decode_megastep(self.state, 8)
            await self._retire_inflight()

        async def _retire_inflight(self):
            return await self._run(lambda t: t.cpu().numpy(), self.flight)
"""


def test_torch_purity_fires_on_each_seeded_sync(tmp_path):
    root = _fake_repo(tmp_path, {
        "crowdllama_tpu_torch/engine/seeds.py": PURITY_SEEDS})
    got = {(f.code, f.symbol): f for f in
           torch_purity.check_torch_purity(root)}
    assert set(got) == {("host-sync-in-decode-loop", s) for s in (
        "per_step_item", "per_step_asarray", "per_step_sync", "_loop")}
    assert "`.cpu()`" in got[("host-sync-in-decode-loop", "_loop")].message
    assert "np.asarray" in got[("host-sync-in-decode-loop",
                                "per_step_asarray")].message


def test_torch_purity_allows_host_data_and_the_retire_read_back(tmp_path):
    root = _fake_repo(tmp_path, {
        "crowdllama_tpu_torch/engine/negatives.py": PURITY_NEGATIVES})
    assert torch_purity.check_torch_purity(root) == []


def test_the_schedulers_read_back_is_the_one_sanctioned_sync(monkeypatch):
    """The real scheduler's loop reaches its retire's read-back: without
    the sanction the rule flags it, with it the tree is clean."""
    monkeypatch.setattr(torch_purity, "RETIRE_METHODS", frozenset())
    found = [f for f in torch_purity.check_torch_purity(repo_root())
             if f.path.endswith("engine/scheduler.py")]
    assert [(f.symbol, f.message.split("`")[1]) for f in found] == [
        ("_loop", ".cpu()")]
    src = (ROOT / found[0].path).read_text().splitlines()
    assert "lambda" in src[found[0].line - 1]


# --------------------------------------------------------- ffi-contract


def test_ffi_reads_all_17_declarations_equal_to_the_exports():
    exports, decls = c_exports(str(ROOT)), py_declarations(str(ROOT))
    assert len(exports) == len(decls) == 17
    assert sorted(exports) == sorted(decls)
    assert check_ffi_contract(str(ROOT)) == []


def _native_copy(tmp_path, edit):
    dst = tmp_path / "crowdllama_tpu_torch" / "native"
    shutil.copytree(ROOT / "crowdllama_tpu_torch" / "native", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = tmp_path / PY_DECL
    p.write_text(edit(p.read_text()))
    return str(tmp_path)


def test_ffi_reports_each_rule_on_a_drifted_copy(tmp_path):
    def drift(text):
        edits = [
            ('"cl_rt_remove": (ctypes.c_int, [vp, cp]),',
             '"cl_rt_remove": (ctypes.c_int, [vp]),'),           # arity
            ('"cl_rt_size": (ctypes.c_long, [vp]),',
             '"cl_rt_size": (ctypes.c_int, [vp]),'),             # restype
            ('"cl_aead_ctr":', '"cl_aead_counter":'),            # renamed
            ('        "cl_rt_free": (None, [vp]),\n', ''),       # removed
        ]
        for old, new in edits:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        return text

    found = {(f.code, f.symbol) for f in
             check_ffi_contract(_native_copy(tmp_path, drift))}
    assert found == {("ffi-arity", "cl_rt_remove"),
                     ("ffi-restype", "cl_rt_size"),
                     ("ffi-unknown-symbol", "cl_aead_counter"),
                     ("ffi-undeclared", "cl_aead_ctr"),
                     ("ffi-undeclared", "cl_rt_free")}


def test_ffi_fails_when_it_reads_no_declarations(tmp_path):
    """A checker that finds nothing to read fails instead of passing:
    here ``_declare`` sets restypes JAX-style, with no ``sigs`` dict."""
    def jax_style(text):
        start = text.index("    sigs = {")
        end = text.index("    return lib\n", start)
        return (text[:start] + "    lib.cl_rt_free.restype = None\n"
                "    lib.cl_rt_free.argtypes = [vp]\n" + text[end:])

    root = _native_copy(tmp_path, jax_style)
    assert py_declarations(root) == {}
    found = check_ffi_contract(root)
    assert ("ffi-undeclared", "_declare") in {(f.code, f.symbol)
                                              for f in found}
    assert len([f for f in found if f.code == "ffi-undeclared"]) == 18


# ------------------------------------------------------------------ CLI


def test_cli_exit_codes_and_json(tmp_path, capsys):
    assert cli_main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert cli_main(["--format=json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["findings"] == [] and report["checkers"] == [
        "async-hotpath", "ffi-contract", "torch-purity"]
    root = _native_copy(tmp_path, lambda t: t)
    _fake_repo(tmp_path, {"crowdllama_tpu_torch/net/bad.py": """
        import time


        async def stall():
            time.sleep(1)
    """})
    assert cli_main(["--root", root, "--format=json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [(f["checker"], f["code"], f["symbol"])
            for f in report["findings"]] == [
        ("async-hotpath", "blocking-call", "stall")]
    assert cli_main(["--root", root, "--checker", "ffi-contract"]) == 0
    capsys.readouterr()
    bad = tmp_path / "bad.toml"
    bad.write_text("checker = 3\n")
    assert cli_main(["--baseline", str(bad)]) == 2
