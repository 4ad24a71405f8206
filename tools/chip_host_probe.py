#!/usr/bin/env python
"""Host-memory probe of the machine that holds the card, for the moment
offload (optim/adamw.py, runtime/hostmem.py; PERF.md §4, §6).

  python3 tools/chip_host_probe.py      # one CUDA card, ~70 GB free host memory

Prints `free -g`, `ulimit -l`, the card's name and power limit, and the
Python / torch / CUDA versions; how many bytes PyTorch's caching host
allocator takes for a 805 MB pinned tensor (it rounds up to a power of
two); whether an fp8 tensor copies into pinned memory bit for bit; for 8
GB and 60 GB host buffers, the seconds of zeroing them and of page-locking
them with cudaHostRegister, and the pinned D2H and H2D rates of 1 GiB
slices of them (CUDA events); the seconds the caching allocator takes for
16e9 pinned bytes; and, at the train cell's embedding shape (153600 x 3584
bf16, [1, 8192] Zipfian ids), whether index_select's and F.embedding's
backward give bitwise the same table gradient on five calls, and each
one's forward-and-backward ms.  Measurement only: nothing here is used by
the port.
"""
import subprocess
import sys
import time
import resource

import numpy as np
import torch
import torch.nn.functional as F


def sh(cmd):
    print("$", cmd)
    print(subprocess.run(cmd, shell=True, capture_output=True, text=True).stdout)


def host_buffers():
    cudart = torch.cuda.cudart()
    print("cudart attrs", [a for a in dir(cudart) if not a.startswith("__")])
    a = torch.empty(3 * 2**28 + 7, dtype=torch.uint8, pin_memory=True)
    print("host_memory_stats", {k: v for k, v in torch.cuda.host_memory_stats().items()
                                if "bytes" in k.lower()})
    del a
    x = torch.randn(1024, 1024, device="cuda").to(torch.float8_e4m3fn)
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    print("fp8 pinned copy ok", torch.equal(h.view(torch.uint8).cuda(), x.view(torch.uint8)),
          h.is_pinned())
    for gb in (8, 60):
        n = gb * 10**9
        t0 = time.perf_counter()
        buf = torch.zeros(n, dtype=torch.uint8)
        t1 = time.perf_counter()
        err = cudart.cudaHostRegister(buf.data_ptr(), n, 0)
        t2 = time.perf_counter()
        print(f"{gb} GB: zeros {t1 - t0:.2f} s, register {t2 - t1:.2f} s, err {err}, "
              f"pinned {buf.is_pinned()}, view pinned {buf[12345:999999].is_pinned()}")
        dev = torch.empty(2**30, dtype=torch.uint8, device="cuda")
        for way in ("d2h", "h2d"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(5):
                part = buf[i * 2**30:(i + 1) * 2**30]
                if way == "d2h":
                    part.copy_(dev, non_blocking=True)
                else:
                    dev.copy_(part, non_blocking=True)
            end.record()
            end.synchronize()
            print(way, 5 * 2**30 / (start.elapsed_time(end) / 1e3) / 1e9, "GB/s")
        t3 = time.perf_counter()
        print("unregister", cudart.cudaHostUnregister(buf.data_ptr()),
              f"{time.perf_counter() - t3:.2f} s")
        del dev, buf, part
        sh("free -g")
    t0 = time.perf_counter()
    p = torch.empty(16 * 10**9, dtype=torch.uint8, pin_memory=True)
    print(f"caching host alloc 16e9: {time.perf_counter() - t0:.2f} s")
    print("host_memory_stats", {k: v for k, v in torch.cuda.host_memory_stats().items()
                                if "bytes" in k.lower()})
    sh("free -g")
    del p


def embedding():
    torch.manual_seed(0)
    V, d, S = 153600, 3584, 8192
    table = (torch.randn(V, d, device="cuda") * 0.02).to(torch.bfloat16)
    ids = torch.from_numpy(np.minimum(np.random.default_rng(0).zipf(1.2, size=(1, S)),
                                      V - 1).astype(np.int64)).cuda()
    gout = torch.randn(1, S, d, device="cuda").to(torch.bfloat16)

    def g_index_select():
        t = table.detach().requires_grad_()
        r = t.index_select(0, ids.reshape(-1)).reshape(1, S, d)
        return torch.autograd.grad(r, t, gout)[0]

    def g_embedding():
        t = table.detach().requires_grad_()
        return torch.autograd.grad(F.embedding(ids, t), t, gout)[0]

    for name, fn in (("index_select", g_index_select), ("embedding", g_embedding)):
        outs = [fn() for _ in range(5)]
        print(name, "bitwise equal over 5 calls:", all(torch.equal(outs[0], o) for o in outs[1:]))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        print(name, "fwd+bwd ms", start.elapsed_time(end) / 10)
    a, b = g_index_select().float(), g_embedding().float()
    print("rel diff", ((a - b).norm() / b.norm()).item())


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_host_probe: no CUDA device")
    sh("free -g")
    sh("ulimit -l")
    sh("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    sh("nproc; cat /proc/meminfo | head -5")
    print(sys.version, torch.__version__, torch.version.cuda)
    print("RLIMIT_MEMLOCK", resource.getrlimit(resource.RLIMIT_MEMLOCK))
    host_buffers()
    embedding()


if __name__ == "__main__":
    main()
