"""``python -m crowdllama_tpu_torch.analysis [--format=json]``: exit 0 when
the baseline waives every finding, 1 on any other, 2 on a bad baseline."""

from __future__ import annotations

import argparse
import json
import sys
import time

from crowdllama_tpu_torch.analysis import all_checkers, load_baseline, repo_root


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m crowdllama_tpu_torch.analysis",
        description="the port's static analysis: async-hotpath, "
                    "torch-purity, ffi-contract and contracts checkers")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="waiver file (default: analysis/baseline.toml)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: the one holding the package)")
    ap.add_argument("--checker", choices=sorted(all_checkers()) + ["all"],
                    default="all", help="run one checker only")
    args = ap.parse_args(argv)

    root = args.root or repo_root()
    try:
        baseline = load_baseline(args.baseline)
    except ValueError as e:
        print(f"analysis: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    checkers = all_checkers()
    selected = checkers if args.checker == "all" else \
        {args.checker: checkers[args.checker]}
    findings = []
    for fn in selected.values():
        findings.extend(fn(root))
    new = [f for f in findings if not baseline.waives(f)]
    waived = len(findings) - len(new)
    elapsed = time.perf_counter() - t0

    if args.format == "json":
        print(json.dumps({
            "findings": [f.as_json() for f in new],
            "waived": waived,
            "stale_waivers": baseline.stale(),
            "elapsed_s": round(elapsed, 3),
            "checkers": sorted(selected),
        }, indent=2))
    else:
        for f in sorted(new, key=lambda f: (f.path, f.line)):
            print(f.render())
        stale = baseline.stale()
        for e in stale:
            print(f"analysis: stale waiver (matched nothing): "
                  f"{e['checker']}/{e['code']} {e['path']} {e['symbol']}",
                  file=sys.stderr)
        print(f"analysis: {len(new)} finding(s), {waived} waived, "
              f"{len(stale)} stale waiver(s), {elapsed:.1f}s")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
