"""Imported by each of the port's CPU test files for its one effect: torch
runs one intra-op thread in the test process.

The tier-1 run puts six pytest workers, each a process, on the CPU.  torch's
default of one intra-op thread per core in each of them oversubscribes the
cores, and its OpenMP threads then spin against each other: six copies of
the reduced CPU train CLI took 333-335 s each at the default and 16-19 s
each at one thread, side by side on an 8-core machine
(tools/cpu_threads_probe.py)."""
import torch

torch.set_num_threads(1)
