#!/usr/bin/env python3
"""Summarize a jax.profiler trace: total device time per op name.

Usage: python tools/summarize_trace.py /tmp/vgt_trace
"""

import collections
import glob
import gzip
import json
import sys


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/vgt_trace"
    paths = sorted(glob.glob(root + "/**/*.trace.json.gz", recursive=True))
    if not paths:
        print("no trace.json.gz under", root)
        return 1
    with gzip.open(paths[-1], "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    # every complete (X) event, device and host
    totals = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        totals[name] += e.get("dur", 0)
    print(f"{'op':60s} {'total ms':>10s}")
    for name, us in totals.most_common(40):
        print(f"{name[:60]:60s} {us/1e3:10.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
