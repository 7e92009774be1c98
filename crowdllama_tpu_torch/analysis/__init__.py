"""The port's static analysis: three checkers over
``crowdllama_tpu_torch/``.

Counterpart of ``crowdllama_tpu/analysis/`` (swarmlint), with the rules
that guard seams only the port has:

- :mod:`.async_hotpath`: no blocking call, lost coroutine or unlocked
  shared-state mutation in the asyncio request plane (gateway, peer,
  peermanager, net, swarm, obs, ipc);
- :mod:`.torch_purity`: no host sync in a loop that dispatches decode
  work (the scheduler's loop read through the methods it runs), the
  flight's one read-back in its retire aside;
- :mod:`.ffi_contract`: every ``extern "C"`` export of the native plane
  declared in ctypes with its arity and return type, and nothing else
  declared.

Findings resolve against ``analysis/baseline.toml`` (empty: zero
waivers).  Run::

    python -m crowdllama_tpu_torch.analysis [--format=json]

which exits 1 on any finding the baseline does not waive.
"""

from __future__ import annotations

from crowdllama_tpu_torch.analysis.base import (
    Baseline,
    Finding,
    load_baseline,
    repo_root,
)


def all_checkers():
    """name -> callable(root) for every checker."""
    from crowdllama_tpu_torch.analysis.async_hotpath import (
        check_async_hotpath,
    )
    from crowdllama_tpu_torch.analysis.ffi_contract import check_ffi_contract
    from crowdllama_tpu_torch.analysis.torch_purity import check_torch_purity

    return {
        "async-hotpath": check_async_hotpath,
        "torch-purity": check_torch_purity,
        "ffi-contract": check_ffi_contract,
    }


def run_all(root: str | None = None,
            baseline: Baseline | None = None) -> list[Finding]:
    """Every checker over the package; the findings ``baseline`` does not
    waive (an empty Baseline shows them all)."""
    root = root or repo_root()
    if baseline is None:
        baseline = load_baseline()
    findings: list[Finding] = []
    for fn in all_checkers().values():
        findings.extend(fn(root))
    return [f for f in findings if not baseline.waives(f)]


__all__ = ["Finding", "Baseline", "load_baseline", "repo_root",
           "all_checkers", "run_all"]
