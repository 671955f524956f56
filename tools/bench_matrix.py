#!/usr/bin/env python
"""Benchmark matrix runner: every BASELINE-shaped config through
bench.py, each in its own subprocess.

The subprocesses run strictly one after another, and this parent never
imports JAX: a JAX process reserves most of the card's memory, so two at
once would not fit, and two sharing the card would spoil each other's
times.  Results print as a table plus one JSON line per config (each
naming the device it ran on).

    python tools/bench_matrix.py [--quick] [--out rows.jsonl]
"""

import json
import os
import subprocess
import sys

CONFIGS = [
    # (label, env overrides)
    ("1080p 24->60",        {"MFI_BENCH_WIDTH": "1920",
                             "MFI_BENCH_HEIGHT": "1080",
                             "MFI_BENCH_DST_FPS": "60"}),
    ("1080p 25->60",        {"MFI_BENCH_WIDTH": "1920",
                             "MFI_BENCH_HEIGHT": "1080",
                             "MFI_BENCH_SRC_FPS": "25",
                             "MFI_BENCH_DST_FPS": "60"}),
    # pair-grouped dispatch (engine.push_many): the transcode/serving
    # path
    ("1080p 24->60 grouped x8", {"MFI_BENCH_WIDTH": "1920",
                                 "MFI_BENCH_HEIGHT": "1080",
                                 "MFI_BENCH_DST_FPS": "60",
                                 "MFI_BENCH_GROUP": "8",
                                 "MFI_BENCH_SKIP_P99": "1"}),
    ("640x360 24->60 grouped x8", {"MFI_BENCH_WIDTH": "640",
                                   "MFI_BENCH_HEIGHT": "360",
                                   "MFI_BENCH_DST_FPS": "60",
                                   "MFI_BENCH_GROUP": "8",
                                   "MFI_BENCH_SKIP_P99": "1"}),
    ("4K 24->120 (headline)", {}),
    ("4K P010 24->120",     {"MFI_BENCH_P010": "1"}),
    ("4K P010 hopperxq 24->120", {"MFI_BENCH_P010": "1",
                                  "MFI_BENCH_MODEL": "hopperxq"}),
    ("4K hopperq+subpel 24->120", {"MFI_BENCH_MODEL": "hopperq",
                                   "MFI_BENCH_SUBPEL": "1"}),
    ("8K 24->60",           {"MFI_BENCH_WIDTH": "7680",
                             "MFI_BENCH_HEIGHT": "4320",
                             "MFI_BENCH_DST_FPS": "60",
                             "MFI_BENCH_FRAMES": "24"}),
]


def run(label, env_over, quick=False):
    env = {**os.environ, "MFI_BENCH_SKIP_PARITY": "1",
           "MFI_BENCH_SKIP_DEFAULT": "1", **env_over}
    if quick:
        env.setdefault("MFI_BENCH_FRAMES", "12")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        r = subprocess.run([sys.executable, os.path.join(here, "bench.py")],
                           capture_output=True, text=True, timeout=900,
                           env=env, cwd=here)
        line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        data = json.loads(line)
    except (subprocess.TimeoutExpired, json.JSONDecodeError) as e:
        return {"metric": label, "value": 0, "error": str(e)[:200]}
    data["label"] = label
    return data


def main():
    quick = "--quick" in sys.argv
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
    rows = []
    for label, env_over in CONFIGS:
        data = run(label, env_over, quick)
        rows.append(data)
        print(json.dumps(data), flush=True)
        if out_path:                 # write incrementally: a failed
            with open(out_path, "w") as fh:   # config keeps prior rows
                for d in rows:
                    fh.write(json.dumps(d) + "\n")
    print()
    print(f"{'config':>28} {'out-fps':>10} {'device':>24}")
    for d in rows:
        print(f"{d.get('label', ''):>28} {d.get('value', 0):>10.0f} "
              f"{d.get('device_kind', d.get('error', '?')):>24}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
