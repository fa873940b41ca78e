"""Per-file timeline of a pytest(-xdist) run: the worker that ran each test
file, when its tests started and ended, and the CPU seconds they took
(the worker's own and its child processes').

As a plugin it appends a JSON line at each test's start and end to
``$TIMELINE_DIR/<worker>.jsonl`` (``gw0``.. under pytest-xdist):

    TIMELINE_DIR=out PYTHONPATH=tests python -m pytest tests/ -n 6 \\
        --dist loadfile -p torch_tier1_timeline

Then ``python tests/torch_tier1_timeline.py out [START]`` prints a row per
file in the order the files started: worker, tests, start and end in
seconds after ``START`` (a Unix time, such as ``date +%s.%N`` before the
run; the first test's start if omitted), the file's span and CPU seconds,
and the total CPU seconds.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

_log = None
_controller = False


def pytest_configure(config):
    global _controller  # an xdist run's controller: its workers record
    _controller = not hasattr(config, "workerinput") and config.getoption("dist", "no") != "no"


def _event(kind: str, nodeid: str) -> None:
    global _log
    if _controller:
        return
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if _log is None:
        out = Path(os.environ.get("TIMELINE_DIR", "timeline"))
        out.mkdir(parents=True, exist_ok=True)
        _log = open(out / f"{worker or 'main'}.jsonl", "a", buffering=1)
    t = os.times()
    _log.write(json.dumps({"ev": kind, "id": nodeid, "t": time.time(),
                           "cpu": t.user + t.system,
                           "children": t.children_user + t.children_system}) + "\n")


def pytest_runtest_logstart(nodeid, location):
    _event("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _event("end", nodeid)


def files(out: Path) -> dict:
    """test file -> worker, tests, first start, last end, CPU seconds."""
    table = {}
    for log in sorted(out.glob("*.jsonl")):
        started = {}
        for line in log.read_text().splitlines():
            e = json.loads(line)
            f = table.setdefault(e["id"].split("::")[0],
                                 {"worker": log.stem, "tests": 0, "start": e["t"], "end": None,
                                  "cpu": 0.0})
            if e["ev"] == "start":
                started[e["id"]] = e
                f["start"] = min(f["start"], e["t"])
            elif e["id"] in started:
                s = started.pop(e["id"])
                f["tests"] += 1
                f["end"] = e["t"] if f["end"] is None else max(f["end"], e["t"])
                f["cpu"] += e["cpu"] - s["cpu"] + e["children"] - s["children"]
    return table


def main(out: str, start: str | None = None) -> None:
    table = files(Path(out))
    t0 = float(start) if start else min(f["start"] for f in table.values())
    print(f"{'file':44s} {'worker':6s} {'tests':>5s} {'start':>8s} {'end':>8s} {'span':>8s} "
          f"{'CPU s':>8s}")
    for name, f in sorted(table.items(), key=lambda kv: kv[1]["start"]):
        end = f["end"] if f["end"] is not None else float("nan")
        print(f"{name:44s} {f['worker']:6s} {f['tests']:5d} {f['start'] - t0:8.1f} "
              f"{end - t0:8.1f} {end - f['start']:8.1f} {f['cpu']:8.1f}")
    print(f"total CPU s {sum(f['cpu'] for f in table.values()):.1f}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
