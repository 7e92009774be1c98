"""The port's static analysis (``crowdllama_tpu_torch/analysis/``): the
port's tree is clean under all four checkers within the 30 s budget
with zero waivers; each rule fires on a seeded violation and stays quiet
on the idiom it must allow; ``async_hotpath`` finds what the JAX
package's checker finds on the same source laid out under either
package; the FFI checker reads all 17 declarations of
``native/__init__.py`` and reports each of its four rules on a drifted
copy; ``contracts`` fires each of its codes on a seeded violation as the
JAX package's checker does on the same violation in its own tree, reads
the port's tree clean and skips the golden ``crowdllama_engine`` token;
the CLI's exit codes and JSON."""

import json
import shutil
import textwrap
import time
from pathlib import Path

import pytest

from crowdllama_tpu.analysis.async_hotpath import (
    check_async_hotpath as jax_async_hotpath,
)
from crowdllama_tpu.analysis import contracts as jax_contracts
from crowdllama_tpu_torch.analysis import (
    contracts,
    load_baseline,
    repo_root,
    run_all,
    torch_purity,
)
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


# ------------------------------------------------------------ contracts

CONFIG_SEED = """
    import os


    class Configuration:
        alpha: int = 1
        beta: str = ""
        gamma: int = 2

        @classmethod
        def from_environment(cls, **overrides):
            env = os.environ
            cfg = cls()
            cfg.alpha = int(env.get("CROWDLLAMA_TPU_ALPHA", cfg.alpha))
            cfg.gamma = int(env.get("CROWDLLAMA_TPU_GAMMA", cfg.gamma))
            return cfg

        @classmethod
        def add_flags(cls, ap):
            ap.add_argument("--alpha", type=int)
            ap.add_argument("--gamma", type=int)
            ap.add_argument("--delta", type=int)

        @classmethod
        def from_flags(cls, args):
            cfg = cls.from_environment()
            for name in ("alpha",):
                setattr(cfg, name, getattr(args, name))
            return cfg
"""

# The same violations in the port's idiom: the environment and the flags
# read through class tables.
CONFIG_TABLE_SEED = """
    import os


    class Configuration:
        alpha: int = 1
        beta: str = ""
        gamma: int = 2

        _ENV = {"alpha": "CROWDLLAMA_TPU_ALPHA",
                "gamma": "CROWDLLAMA_TPU_GAMMA"}
        _FLAG_FIELDS = ("alpha",)

        @classmethod
        def from_environment(cls, **overrides):
            cfg = cls()
            for name, var in cls._ENV.items():
                if var in os.environ:
                    setattr(cfg, name, int(os.environ[var]))
            return cfg

        @staticmethod
        def add_flags(ap):
            ap.add_argument("--alpha", type=int)
            ap.add_argument("--gamma", type=int)
            ap.add_argument("--delta", type=int)

        @classmethod
        def from_flags(cls, args):
            return cls.from_environment(
                **{k: getattr(args, k) for k in cls._FLAG_FIELDS})
"""

METRICS_SEED = """
    def expose(key):
        lines = ["# TYPE crowdllama_documented_total counter",
                 "# TYPE crowdllama_undocumented_total counter"]
        lines.append(f"crowdllama_dyn_{key}_total 1")
        return lines
"""

FAULT_TEST_SEED = """
    import pytest

    from PKG.testing.faults import FaultRule


    def test_seed():
        FaultRule(site="nope.site")
        with pytest.raises(ValueError):
            FaultRule(site="deliberately.bad")
"""


def _codes(findings) -> set:
    return {(f.code, f.symbol) for f in findings}


def _laid_out(tmp_path, files):
    """``files`` ({relpath: source}, ``PKG`` standing for the package and
    ``TEST`` for a test module's name) under the port's and the JAX
    package's layouts: (port root, JAX root)."""
    roots = []
    for pkg, test in (("crowdllama_tpu_torch", "test_torch_fx"),
                      ("crowdllama_tpu", "test_fx")):
        roots.append(_fake_repo(tmp_path / pkg, {
            rel.replace("PKG", pkg).replace("TEST", test):
            text.replace("PKG", pkg) for rel, text in files.items()}))
    return roots


def test_contract_config_rules_fire_as_the_jax_checker(tmp_path):
    port, jax = _laid_out(tmp_path, {"PKG/config.py": CONFIG_SEED})
    got = _codes(contracts.check_config_parity(port))
    assert got == _codes(jax_contracts.check_config_parity(jax)) == {
        ("config-no-env", "beta"), ("config-unknown-dest", "delta"),
        ("config-flag-unconsumed", "gamma")}
    table = _fake_repo(tmp_path / "table", {
        "crowdllama_tpu_torch/config.py": CONFIG_TABLE_SEED})
    assert _codes(contracts.check_config_parity(table)) == got


def test_contract_metrics_rules_fire_as_the_jax_checker(tmp_path):
    port, jax = _laid_out(tmp_path, {
        "PKG/obs/fx.py": METRICS_SEED,
        "docs/OBSERVABILITY.md": (
            "`crowdllama_documented_total` and the `crowdllama_dyn_fast`\n"
            "family; `crowdllama_vanished_total` (no longer emitted).\n")})
    got = _codes(contracts.check_metrics_docs(port))
    assert got == _codes(jax_contracts.check_metrics_docs(jax)) == {
        ("metrics-undocumented", "crowdllama_undocumented_total"),
        ("metrics-stale-doc", "crowdllama_vanished_total")}


def test_contract_fault_site_rules_fire_as_the_jax_checker(tmp_path):
    from crowdllama_tpu.testing.faults import FAULT_SITES as JAX_SITES
    from crowdllama_tpu_torch.testing.faults import FAULT_SITES

    assert set(FAULT_SITES) == set(JAX_SITES)
    inject_all = "\n".join(
        f'    await faults.inject("{s}")' for s in FAULT_SITES)
    port, jax = _laid_out(tmp_path, {
        "PKG/fx.py": ("from PKG.testing import faults\n\n\n"
                      "async def run():\n"
                      f"{inject_all}\n"
                      '    await faults.inject("bogus.site")\n'),
        "tests/TEST.py": FAULT_TEST_SEED})
    got = _codes(contracts.check_fault_sites(port))
    assert got == _codes(jax_contracts.check_fault_sites(jax)) == {
        ("fault-site-unregistered", "bogus.site"),
        ("fault-site-unknown-in-test", "nope.site")}
    # Without the instrumented module every registered site is dead.
    (Path(port) / "crowdllama_tpu_torch" / "fx.py").unlink()
    dead = _codes(contracts.check_fault_sites(port))
    assert dead == {("fault-site-unknown-in-test", "nope.site")} | {
        ("fault-site-uninstrumented", s) for s in FAULT_SITES}
    # The JAX package's tests build the JAX package's rules: not read.
    _fake_repo(Path(port), {
        "tests/test_fx.py": 'FaultRule(site="jax.only.site")\n'})
    assert _codes(contracts.check_fault_sites(port)) == dead


def test_contract_oneof_rules_fire_as_the_jax_checker(tmp_path):
    from crowdllama_tpu.core import llama_v1_pb2 as pb

    arms = contracts._oneof_arms()
    assert arms == [f.name for f in
                    pb.BaseMessage.DESCRIPTOR.oneofs_by_name["message"].fields]
    assert contracts.RESPONSE_ARMS == jax_contracts.RESPONSE_ARMS
    requests = [a for a in arms if a not in contracts.RESPONSE_ARMS]
    drop_build, drop_extract, drop_dispatch = arms[1], arms[0], requests[-1]
    messages = "\n".join(
        [f"mk = lambda: BaseMessage({a}=None)" for a in arms
         if a != drop_build]
        + [f'WHICH = "{a}"' for a in arms if a != drop_extract])
    peer = "\n".join(f'ok = which == "{a}"' for a in requests
                     if a != drop_dispatch)
    port, jax = _laid_out(tmp_path, {"PKG/core/messages.py": messages,
                                     "PKG/peer/peer.py": peer})
    got = _codes(contracts.check_oneof(port))
    assert got == _codes(jax_contracts.check_oneof(jax)) == {
        ("oneof-constructor", drop_build), ("oneof-extractor", drop_extract),
        ("oneof-dispatch", drop_dispatch)}


def test_contracts_read_the_ports_tree_clean_with_zero_waivers():
    """Every contract reads something on the port's tree (none is a
    no-op) and finds nothing; the baseline waives nothing."""
    root = repo_root()
    assert contracts.check_contracts(root) == []
    assert load_baseline().entries == []
    assert len(contracts._oneof_arms()) == 14
    assert len(contracts._inject_sites(root)) >= 10
    exact, prefixes = contracts.collect_metric_families(root)
    assert len(exact) > 50
    assert "crowdllama_request_seconds" in exact
    assert "crowdllama_engine_" in prefixes


def test_the_golden_metrics_fetch_prefix_is_not_a_family():
    """``crowdllama_engine`` alone, the prefix a golden metrics_fetch frame
    asks for, is neither collected nor reported; the families that start
    with it are collected."""
    golden = (ROOT / "crowdllama_tpu_torch/core/wire_golden.py").read_text()
    assert '"crowdllama_engine"' in golden
    exact, prefixes = contracts.collect_metric_families(repo_root())
    assert "crowdllama_engine" not in exact
    assert any(f.startswith("crowdllama_engine_") for f in exact)
    assert not [f for f in contracts.check_metrics_docs(repo_root())
                if f.symbol == "crowdllama_engine"]


# ------------------------------------------------------------------ CLI


def test_cli_exit_codes_and_json(tmp_path, capsys):
    assert cli_main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert cli_main(["--format=json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["findings"] == [] and report["checkers"] == [
        "async-hotpath", "contracts", "ffi-contract", "torch-purity"]
    root = _native_copy(tmp_path, lambda t: t)
    _fake_repo(tmp_path, {"crowdllama_tpu_torch/net/bad.py": """
        import time


        async def stall():
            time.sleep(1)
    """})
    assert cli_main(["--root", root, "--checker", "async-hotpath",
                     "--format=json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [(f["checker"], f["code"], f["symbol"])
            for f in report["findings"]] == [
        ("async-hotpath", "blocking-call", "stall")]
    assert cli_main(["--root", root, "--checker", "ffi-contract"]) == 0
    # A tree without the contracts' anchor files (config.py,
    # core/messages.py, ...) fails loudly instead of passing unchecked.
    with pytest.raises(FileNotFoundError):
        cli_main(["--root", root])
    with pytest.raises(FileNotFoundError):
        cli_main(["--root", root, "--checker", "contracts"])
    capsys.readouterr()
    bad = tmp_path / "bad.toml"
    bad.write_text("checker = 3\n")
    assert cli_main(["--baseline", str(bad)]) == 2
