#!/usr/bin/env python
"""CPU oversubscription probe for the tier-1 test run (tests/_torch_cpu.py).

  python3 tools/cpu_threads_probe.py [--copies 6]

Runs ``copies`` processes side by side, each the port's reduced CPU train
CLI (12 steps, S = 256, B = 8, as tests/test_torch_train.py runs it), once
with torch at its default intra-op thread count and once at one thread,
and prints each process's seconds and the machine's core count.  The tier-1
run puts six pytest workers on the CPU; this shows what torch's default
threads cost them.  Measurement only: nothing here is used by the port.
"""
import argparse
import os
import subprocess
import sys
import time

CHILD = """
import sys, time
import torch
if sys.argv[1] != "default":
    torch.set_num_threads(int(sys.argv[1]))
from repro_torch.launch import train
t0 = time.perf_counter()
train.main(["--reduced", "--steps", "12", "--seq", "256", "--batch", "8", "--device", "cpu",
            "--log-every", "100"])
print(torch.get_num_threads(), time.perf_counter() - t0)
"""


def side_by_side(copies: int, threads: str) -> list:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = {**os.environ, "PYTHONPATH": src}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, threads], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for _ in range(copies)]
    out = [p.communicate()[0].split() for p in procs]
    return [(int(n), float(s)) for n, s in out]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--copies", type=int, default=6)
    args = ap.parse_args(argv)
    print(f"cores: {os.cpu_count()}; {args.copies} copies side by side")
    for threads in ("default", "1"):
        t0 = time.perf_counter()
        runs = side_by_side(args.copies, threads)
        print(f"torch threads {runs[0][0]} each: seconds {[round(s, 1) for _, s in runs]}, "
              f"wall {time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
