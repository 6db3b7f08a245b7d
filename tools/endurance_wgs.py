#!/usr/bin/env python3
"""WGS endurance run with mid-run SIGKILL + resume parity.

Drives tools/rehearse_wgs.py at the reference's headline scale (3 Gb
genome, 5M SNPs, sharded-dictionary mesh) through THREE geno legs over the
same >=2M-read stream:

  A. uninterrupted            -> out_full.vcf      (ground truth)
  B. checkpointed, SIGKILL'd  -> checkpoint on disk (killed ~mid-stream,
     -9: no cleanup, the crash case)
  C. same command re-run      -> resumes from the checkpoint -> out_resumed.vcf

and asserts out_resumed.vcf is BYTE-IDENTICAL to out_full.vcf (counts are
order-independent sums; the checkpoint holds merged counts + the global
read offset, so a resumed run must reproduce the uninterrupted output
exactly). Progress lines (reads/s over time + RSS) from each leg land in
the log for docs/WORKFLOWS.md.

Usage: python tools/endurance_wgs.py [--reads 2097152] [--cache /tmp/vgt_wgs]
           [--kill-after-frac 0.5] [--mesh 4] [--batch 2048]
Expects the WGS index already built (rehearse_wgs.py --phase index).
"""

import argparse
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leg(args, extra, tag):
    cmd = [sys.executable, os.path.join(REPO, "tools", "rehearse_wgs.py"),
           "--phase", "geno", "--cache", args.cache,
           "--mesh", str(args.mesh), "--batch", str(args.batch),
           "--extra-reads", str(args.reads), "--limit-batches", "0",
           *extra]
    print(f"[endurance] leg {tag}: {' '.join(cmd)}", flush=True)
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def stream(p, tag, kill_at_reads=None):
    """Relay the leg's output; optionally SIGKILL once progress passes
    kill_at_reads. Returns (rc, killed)."""
    killed = False
    for line in p.stdout:
        print(f"[{tag}] {line}", end="", flush=True)
        if (kill_at_reads is not None and not killed
                and "progress:" in line):
            try:
                n = int(line.split("progress:")[1].split("reads total")[0])
            except (ValueError, IndexError):
                continue
            if n >= kill_at_reads:
                print(f"[endurance] SIGKILL at {n} reads", flush=True)
                os.kill(p.pid, signal.SIGKILL)
                killed = True
    return p.wait(), killed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_097_152)
    ap.add_argument("--cache", default="/tmp/vgt_wgs")
    ap.add_argument("--mesh", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--kill-after-frac", type=float, default=0.5)
    ap.add_argument("--progress-every", type=float, default=20.0)
    args = ap.parse_args()

    t0 = time.time()
    ck = os.path.join(args.cache, "endurance_ck")
    for suf in (".npz", ".json"):
        try:
            os.remove(ck + suf)
        except OSError:
            pass

    # Leg A: uninterrupted ground truth
    rc, _ = stream(leg(args, ["--out", "out_full.vcf",
                              "--progress-every",
                              str(args.progress_every)], "A"), "A")
    if rc != 0:
        sys.exit(f"leg A failed rc={rc}")

    # Leg B: checkpointed, SIGKILL mid-stream
    kill_at = int(args.reads * args.kill_after_frac)
    rc, killed = stream(
        leg(args, ["--out", "out_resumed.vcf", "--checkpoint", ck,
                   "--progress-every", str(args.progress_every)], "B"),
        "B", kill_at_reads=kill_at)
    if not killed:
        sys.exit(f"leg B finished (rc={rc}) before the kill point "
                 f"{kill_at}; lower --kill-after-frac")
    if not os.path.exists(ck + ".npz"):
        sys.exit("leg B died before writing any checkpoint; raise "
                 "--kill-after-frac or lower --checkpoint-every")

    # Leg C: resume to completion
    rc, _ = stream(leg(args, ["--out", "out_resumed.vcf",
                              "--checkpoint", ck,
                              "--progress-every",
                              str(args.progress_every)], "C"), "C")
    if rc != 0:
        sys.exit(f"leg C (resume) failed rc={rc}")

    full = open(os.path.join(args.cache, "out_full.vcf"), "rb").read()
    res = open(os.path.join(args.cache, "out_resumed.vcf"), "rb").read()
    if full != res:
        sys.exit("PARITY FAIL: resumed output differs from uninterrupted")
    print(f"[endurance] PARITY PASS: kill+resume output byte-identical "
          f"({len(full)} bytes, {args.reads} reads, "
          f"{time.time()-t0:.0f}s total)", flush=True)


if __name__ == "__main__":
    main()
