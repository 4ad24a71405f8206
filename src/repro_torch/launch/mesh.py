"""The mesh's processes (port of ``repro/launch/mesh.py``).

The reference builds a JAX device mesh ``DATA x MODEL`` inside one program;
here every rank of the ``DATA x MODEL`` layout is a process (DESIGN.md §4;
rank = data_index x MODEL + model_index, ``parallel/ctx.py``):

- ``parse_mesh("DxM")``: the reference CLI's ``--mesh``: D data ranks
  (dp x pp) times M model ranks, a world of D x M;
- ``init_from_env``: the process group of a ``torchrun`` launch, from its
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``);
- ``spawn(fn, world, backend=, device=)``: ``world`` ranks as processes of
  this host (the tests' and ``chip_smoke.py``'s launcher), started with the
  ``spawn`` method (CUDA cannot fork) and joined through a ``FileStore`` in
  a temporary directory (no port to pick, no network).  A rank that fails,
  or a run that passes its deadline, fails the whole run: every process is
  stopped and ``spawn`` raises;
- ``rank_device``: ``cuda:LOCAL_RANK`` under NCCL (a card per rank), the
  caller's device for every rank under gloo (several ranks share one card;
  gloo stages their transfers through host memory, ``parallel/ctx.py``).
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch

from repro_torch.parallel.ctx import check_backend


def parse_mesh(text: str) -> tuple:
    """``"DATAxMODEL"`` -> (data, model): the world is data x model ranks."""
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x1") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {text!r}: axes must be >= 1")
    return data, model


def rank_device(backend: str, device, local_rank: int) -> torch.device:
    """The device of a rank: its own card under NCCL, ``device`` under gloo."""
    device = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def init_from_env(backend: str, device="cuda", timeout_s: float = 1800.0) -> tuple:
    """Initialise the process group of a ``torchrun`` launch; returns (rank,
    world, this rank's device)."""
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    check_backend(backend, torch.device(device),
                  int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dev = rank_device(backend, device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, dev


def _entry(rank, world, backend, device, store_path, timeout_s, fn, args, results):
    import torch.distributed as dist

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, world: int, *, backend: str = "gloo", device="cuda", args=(),
          timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` ranks, each a process in
    a process group of ``backend``, their tensors on ``device`` (the card
    by default, as the port's other entry points; ``"cpu"`` for CPU ranks);
    returns the ranks' return values in rank order (they must pickle).  ``fn`` must be importable by name (a module's
    top-level function).  Raises if a rank raises or exits, or if the run
    passes ``timeout_s``; every process is stopped first."""
    import multiprocessing as mp

    check_backend(backend, torch.device(device), world)
    mpc = mp.get_context("spawn")
    results = mpc.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [mpc.Process(target=_entry, args=(r, world, backend, str(device), store,
                                                  timeout_s, fn, args, results),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out, deadline, failures = {}, time.monotonic() + timeout_s, {}
        grace = None     # after a failure, the others' reports are awaited briefly
        try:
            while len(out) + len(failures) < world:
                now = time.monotonic()
                if (grace is not None and now > grace) or (grace is None and now > deadline):
                    break
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and r not in failures and p.exitcode not in (None, 0)]
                    if dead and grace is None:
                        failures[dead[0]] = (f"its process exited with code "
                                             f"{procs[dead[0]].exitcode} before returning")
                        grace = time.monotonic() + 5.0
                    continue
                if ok:
                    out[rank] = value
                else:
                    failures[rank] = value
                    grace = grace or time.monotonic() + 5.0
        finally:
            done = len(out) == world
            for p in procs:
                p.join(timeout=10.0 if done else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if len(out) < world:
        what = "\n".join(f"rank {r} failed:\n{msg}" for r, msg in sorted(failures.items()))
        raise RuntimeError(f"spawn of {world} ranks ({backend}, {device}): "
                           + (what or f"no result after {timeout_s:.0f} s (a rank hangs?)"))
    return [out[r] for r in range(world)]
