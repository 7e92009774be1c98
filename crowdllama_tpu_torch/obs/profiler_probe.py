"""Count the ``torch.profiler`` sessions that record no kernel of the
thread that launches them.

Each child process works as ``chip_smoke.py`` does before its wire
phase's profile, at a small size: it captures CUDA graphs, opens two
sessions in the main thread around a graph replay and eager work, and
frees the graphs.  Then a one-worker pool (the scheduler's dispatch
thread) runs batches of small kernels back to back, and the child takes
``--sessions`` sessions of 0.3 s, counting the kernel events of each
session's Chrome trace: the dispatch thread's, and the three marker
kernels (``fill_``) the thread that opened the session launches in it.
The children take three settings in turn:

- ``side``: the session opens and closes in the main thread while the
  dispatch thread launches (``TorchEngine.capture_profile`` before it
  moved);
- ``attached``: ``side`` with CUPTI kept attached between sessions
  (``TEARDOWN_CUPTI=0``, ``DISABLE_CUPTI_LAZY_REINIT=1``, PyTorch's
  setting for inductor's CUDA graphs);
- ``dispatch``: the session opens and closes on the dispatch thread,
  between two of its batches (``TorchEngine.capture_profile`` now).

Run on a card: ``python -m crowdllama_tpu_torch.obs.profiler_probe
[--runs 4] [--sessions 8]``.  It prints one JSON line per child and a
summary line, ``{"empty_sessions": {setting: n}, "sessions": {...},
"markers_in_empty": {setting: n}}`` (an empty session holds no kernel
of the dispatch thread).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

SETTINGS = ("side", "attached", "dispatch")
ATTACHED = {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}
MARKER = "FillFunctor"
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def _kernels(prof, tmp: str) -> tuple[int, int]:
    """(kernels but the markers, marker kernels) in ``prof``'s trace."""
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    markers = sum(1 for n in names if MARKER in n)
    return len(names) - markers, markers


def _start():
    prof = torch.profiler.profile(activities=ACTIVITIES)
    prof.start()
    return prof


def child(setting: str, sessions: int) -> dict:
    """One process's sessions -> kernel events of each."""
    dev = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=dev)
    w = torch.randn(256, 256, device=dev)
    graphs = []
    side = torch.cuda.Stream()
    for _ in range(4):
        g = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                x @ w
            torch.cuda.synchronize()
            with torch.cuda.graph(g):
                for _ in range(16):
                    (x @ w).relu_()
        torch.cuda.current_stream().wait_stream(side)
        graphs.append(g)
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp()
    first = []
    for fn in (graphs[0].replay,
               lambda: [(x @ w).relu_() for _ in range(16)]):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            fn()
            torch.cuda.synchronize()
        first.append(_kernels(prof, tmp)[0])
    del graphs, g
    torch.cuda.empty_cache()

    dispatch = ThreadPoolExecutor(max_workers=1)
    stop = threading.Event()

    def batch() -> None:
        with torch.inference_mode():
            for _ in range(20):
                (x @ w).relu_()
            torch.cuda.synchronize()

    def feed() -> None:
        while not stop.is_set():
            dispatch.submit(batch).result()
            time.sleep(0.0005)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    marker = torch.empty(1024, device=dev)
    # The opening thread's markers: inline in the main thread, or queued
    # between the dispatch thread's batches.
    on = dispatch if setting == "dispatch" else None

    def mark(i: int) -> None:
        for _ in range(3):
            if on is None:
                marker.fill_(float(i))
            else:
                on.submit(marker.fill_, float(i)).result()
            time.sleep(0.1)

    counts = []
    try:
        for i in range(sessions):
            if on is not None:
                prof = on.submit(_start).result()
                mark(i)
                on.submit(prof.stop).result()
            else:
                prof = _start()
                mark(i)
                prof.stop()
            counts.append(_kernels(prof, tmp))
    finally:
        stop.set()
        feeder.join()
        dispatch.shutdown()
    return {"setting": setting, "first_sessions": first, "kernels": counts}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4,
                    help="child processes per setting")
    ap.add_argument("--sessions", type=int, default=8,
                    help="sessions under load per child")
    ap.add_argument("--child", choices=SETTINGS, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(args.child, args.sessions)), flush=True)
        return 0
    base = {k: v for k, v in os.environ.items() if k not in ATTACHED}
    empty = {s: 0 for s in SETTINGS}
    total = {s: 0 for s in SETTINGS}
    markers = {s: 0 for s in SETTINGS}
    for _ in range(args.runs):
        for s in SETTINGS:
            out = subprocess.run(
                [sys.executable, "-m", "crowdllama_tpu_torch.obs.profiler_probe",
                 "--child", s, "--sessions", str(args.sessions)],
                env={**base, **ATTACHED} if s == "attached" else base,
                capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                print(out.stderr, file=sys.stderr)
                return out.returncode
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            for n, m in line["kernels"]:
                empty[s] += n == 0
                markers[s] += m if n == 0 else 0
            total[s] += len(line["kernels"])
    print(json.dumps({"empty_sessions": empty, "sessions": total,
                      "markers_in_empty": markers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
