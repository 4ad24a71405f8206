"""Parallel context over ``torch.distributed`` (port of ``repro/parallel/ctx.py``).

The reference's ``Ctx`` binds named mesh axes inside one SPMD program; here
each rank is a process of its own and ``Ctx`` holds the process groups of
the data axis (DESIGN.md §4): ``dp x pp`` ranks, stage-major, so rank ``i``
runs pipeline stage ``i % pp`` of dp group ``i // pp``.

- ``psum_grads``: the stage's gradients over its dp group (the ranks of the
  same stage), ``_dp_groups``;
- ``psum_globals``: the globals' gradients, whose contributions live on
  different stages: a leaf that one stage alone uses (the embedding, the
  head) is summed over that stage's dp group and sent from there to the
  other stages, the rest summed over every rank;
- ``psum_loss_all``: over every rank of the data axis;
- ``psum_stages``: over the stages of one dp group;
- ``handoff``: the pipeline's stage hand-off (the reference's
  ``ppermute_stage`` along ``next_stage_perm``) as a differentiable
  exchange: this stage's output goes to stage + 1 and stage - 1's comes in,
  posted together as one ``batch_isend_irecv``; its backward is the
  transpose (the carry's gradient back to stage - 1, the output's gradient
  in from stage + 1).

The model axis is 1: the reference's model-axis methods are the identity at
``sp = 1`` and are not ported; ``sp > 1`` is refused (ROADMAP Queue 1, item
3).  ``SINGLE`` is the one-device context: every reduction is the identity.

The backend is the process group's, named by whoever started it
(``launch.mesh``), never picked here.  ``"nccl"`` needs a CUDA device of
its own for every rank of the host and raises otherwise.  ``"gloo"`` has no
CUDA send/recv: with CUDA tensors every hand-off and reduction is staged
explicitly through pinned host buffers (a synchronous D2H, the transfer,
an H2D), which is how two ranks share one card.  The context counts what
it moves (``counts()``): its exchanges (``handoffs``, forward and backward
alike) with the bytes it sent and their host seconds, the seconds of the
hand-offs' staging copies among them, its all-reduces' bytes, the globals'
bytes it sent to other stages (``bcast_bytes``), and the seconds of both
(their staging included).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch

BACKENDS = ("gloo", "nccl")


def _later(what: str, item: int):
    """The error of what a later slice of the port brings."""
    return NotImplementedError(f"{what} comes with a later slice of the port "
                               f"(ROADMAP Queue 1, item {item})")


def check_backend(backend: str, device: torch.device, local_world: int) -> None:
    """Refuse a backend that cannot carry ``local_world`` ranks of this host
    on ``device``: NCCL wants a card of its own for each (it refuses two
    ranks on one device), gloo takes CPU tensors and stages CUDA ones."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl carries CUDA tensors only (use 'gloo' on the CPU)")
        n = torch.cuda.device_count()
        if n < local_world:
            raise RuntimeError(f"nccl needs one CUDA device per rank: {local_world} "
                               f"ranks on this host, {n} device(s); 'gloo' stages "
                               "each transfer through host memory instead")


class Ctx:
    """The data axis of one rank: ``dp`` groups of ``pp`` stages, ``sp = 1``.

    At ``dp x pp = 1`` the single-device context (``SINGLE``): every
    reduction is the identity and nothing is exchanged.  Over several ranks
    it takes the initialised process group's rank (the rank in the data
    axis) and backend; ``device`` is where this rank's tensors live."""

    def __init__(self, *, dp: int = 1, pp: int = 1, sp: int = 1, device="cuda"):
        if sp != 1:
            raise _later(f"sp = {sp} (a model axis)", 3)
        self.dp, self.pp, self.sp, self.rank = dp, pp, sp, 0
        self.backend = None
        self.device = torch.device(device)
        self._dp_group = self._stage_group = None
        self._counts = {}
        self.reset_counts()
        if dp * pp == 1:
            return
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(f"dp x pp = {dp * pp} ranks need an initialised process "
                               "group (launch.mesh.init_from_env or launch.mesh.spawn)")
        if dist.get_world_size() != dp * pp:
            raise ValueError(f"dp x pp = {dp} x {pp} does not match the process "
                             f"group's {dist.get_world_size()} ranks")
        self.rank, self.backend = dist.get_rank(), dist.get_backend()
        check_backend(self.backend, self.device,
                      int(os.environ.get("LOCAL_WORLD_SIZE", dp * pp)))
        rank = self.rank
        # every rank creates every group, in the same order (new_group is
        # collective); each keeps its own
        for group in self._dp_groups():
            g = dist.new_group(group) if dp > 1 else None
            if rank in group:
                self._dp_group = g
        for group in self._stage_rows():
            g = dist.new_group(group) if pp > 1 else None
            if rank in group:
                self._stage_group = g

    # ----- sizes / indices -------------------------------------------------
    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def world(self) -> int:
        return self.dp * self.pp

    def data_index(self) -> int:
        return self.rank

    def stage_index(self) -> int:
        """Pipeline stage of this rank: data_index % pp (stage-major)."""
        return self.rank % self.pp

    def dp_index(self) -> int:
        return self.rank // self.pp

    def _dp_groups(self):
        """The ranks of each stage across the dp groups (the reference's
        ``axis_index_groups`` of ``psum_grads``)."""
        return [[g * self.pp + s for g in range(self.dp)] for s in range(self.pp)]

    def _stage_rows(self):
        """The stages of each dp group (``psum_stages``' grouping)."""
        return [[g * self.pp + s for s in range(self.pp)] for g in range(self.dp)]

    # ----- counters --------------------------------------------------------
    def counts(self) -> dict:
        return dict(self._counts)

    def reset_counts(self) -> None:
        self._counts.update(handoffs=0, handoff_bytes=0, handoff_s=0.0, staging_s=0.0,
                            reduce_bytes=0, bcast_bytes=0, reduce_s=0.0)

    # ----- reductions ------------------------------------------------------
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    @staticmethod
    def _by_dtype(tensors) -> list:
        """``tensors`` grouped by dtype, in the order each dtype first comes."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        return list(by_dtype.values())

    @staticmethod
    def _unflatten(flat: torch.Tensor, ts) -> None:
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))

    def _all_reduce(self, tensors: Sequence[torch.Tensor], group) -> None:
        """Sum ``tensors`` in place over ``group``: one all-reduce per dtype
        over a flat buffer of its tensors (staged through pinned host memory
        under gloo with CUDA tensors)."""
        import torch.distributed as dist

        t_start = time.perf_counter()
        for ts in self._by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in ts])
            if self._staged():
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                host.copy_(flat)
                dist.all_reduce(host, group=group)
                flat.copy_(host)
            else:
                dist.all_reduce(flat, group=group)
            self._unflatten(flat, ts)
            self._counts["reduce_bytes"] += flat.numel() * flat.element_size()
        self._counts["reduce_s"] += time.perf_counter() - t_start

    def _send_from_owners(self, by_owner: dict) -> None:
        """In place: ``by_owner[s]``, the leaves that stage s alone holds
        the sum of, go from stage s to the other stages of this rank's dp
        group; every send and receive posted together, one flat buffer per
        owner and dtype."""
        import torch.distributed as dist

        t_start = time.perf_counter()
        staged, stage = self._staged(), self.stage_index()
        row = self.dp_index() * self.pp
        ops, recvs = [], []
        for s, leaves in sorted(by_owner.items()):
            for k, ts in enumerate(self._by_dtype(leaves)):
                tag = s * 64 + k
                if s == stage:
                    flat = torch.cat([t.reshape(-1) for t in ts])
                    if staged:
                        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                        flat = host.copy_(flat)
                    for peer in range(self.pp):
                        if peer != stage:
                            ops.append(dist.P2POp(dist.isend, flat, row + peer, tag=tag))
                            self._counts["bcast_bytes"] += flat.numel() * flat.element_size()
                else:
                    buf = torch.empty(sum(t.numel() for t in ts), dtype=ts[0].dtype,
                                      pin_memory=staged,
                                      device="cpu" if staged else self.device)
                    ops.append(dist.P2POp(dist.irecv, buf, row + s, tag=tag))
                    recvs.append((buf, ts))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for buf, ts in recvs:
            self._unflatten(buf.to(self.device), ts)
        self._counts["reduce_s"] += time.perf_counter() - t_start

    def psum_grads(self, tensors) -> None:
        """In place: gradient reduction across the dp replicas of this stage."""
        if self.distributed and self.dp > 1:
            self._all_reduce(list(tensors), self._dp_group)

    def psum_globals(self, tensors, used: Optional[Sequence[bool]] = None) -> None:
        """In place: the global parameters' gradients summed over every rank
        (their contributions live on different stages).

        ``used[i]`` says whether ``tensors[i]``'s gradient came out of this
        rank's graph (default: all of them).  A leaf that one stage alone
        uses (at pp > 1 the embedding on stage 0, the final norm and the
        head on the last) is summed over that stage's dp group and sent
        from there to the other stages of each dp group: each stage sends
        what it owns and receives the rest, where an all-reduce would move
        every leaf twice and add the other stages' zeros.  A leaf that
        several stages use (a tied embedding) is all-reduced over every
        rank.  Every rank learns which stages use what from one small
        all-reduce, so that all split the leaves alike."""
        if not (self.distributed and self.world > 1):
            return
        tensors = list(tensors)
        if not tensors:
            return
        mask = torch.zeros((self.pp, len(tensors)), dtype=torch.int32, device=self.device)
        mask[self.stage_index()] = torch.tensor(
            [True] * len(tensors) if used is None else list(used), dtype=torch.int32)
        self._all_reduce([mask], None)
        rows = mask.tolist()
        owners = [[s for s in range(self.pp) if rows[s][i]] for i in range(len(tensors))]
        shared = [t for t, o in zip(tensors, owners) if len(o) > 1]
        if shared:
            self._all_reduce(shared, None)
        by_owner = {s: [t for t, o in zip(tensors, owners) if o == [s]] for s in range(self.pp)}
        self.psum_grads(by_owner[self.stage_index()])
        self._send_from_owners({s: ts for s, ts in by_owner.items() if ts})

    def psum_loss_all(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar summed over every rank (a new tensor, no gradient)."""
        x = x.detach().clone()
        if self.distributed and self.world > 1:
            self._all_reduce([x], None)
        return x

    def psum_stages(self, tensors) -> None:
        """In place: a sum over the pipeline stages of this rank's dp group
        (the reference replicates the last stage's sampled decode tokens
        with it)."""
        if self.distributed and self.pp > 1:
            self._all_reduce(list(tensors), self._stage_group)

    def barrier(self) -> None:
        if self.distributed:
            import torch.distributed as dist

            dist.barrier()

    # ----- the stage hand-off ----------------------------------------------
    def exchange(self, send: Optional[torch.Tensor], to: Optional[int],
                 recv_like: Optional[tuple], frm: Optional[int], tag: int):
        """Send ``send`` to rank ``to`` and receive a tensor of ``recv_like``
        = (shape, dtype) from rank ``frm``, posted together; either side may
        be None.  Returns the received tensor on this rank's device (None
        where nothing was received)."""
        import torch.distributed as dist

        staged = self._staged()
        ops, recv_buf = [], None
        if staged:
            # the staging copies wait for the work queued on the stream:
            # wait here, so that their time is the copies' own
            torch.cuda.current_stream(self.device).synchronize()
        t_start = t0 = time.perf_counter()
        if send is not None:
            buf = send.detach().contiguous()
            if staged:
                host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                host.copy_(buf)
                buf = host
            ops.append(dist.P2POp(dist.isend, buf, to, tag=tag))
            self._counts["handoff_bytes"] += buf.numel() * buf.element_size()
        if recv_like is not None:
            shape, dtype = recv_like
            recv_buf = torch.empty(shape, dtype=dtype, pin_memory=staged,
                                   device="cpu" if staged else self.device)
            ops.append(dist.P2POp(dist.irecv, recv_buf, frm, tag=tag))
        self._counts["staging_s"] += time.perf_counter() - t0
        if not ops:
            return None
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._counts["handoffs"] += 1
        if recv_buf is not None and staged:
            t0 = time.perf_counter()
            recv_buf = recv_buf.to(self.device)
            self._counts["staging_s"] += time.perf_counter() - t0
        self._counts["handoff_s"] += time.perf_counter() - t_start
        return recv_buf

    def handoff(self, x: Optional[torch.Tensor], recv_like: Optional[tuple],
                token: torch.Tensor, tick: int):
        """The stage hand-off of tick ``tick``: ``x`` (this stage's output,
        or None) goes to stage + 1, and a tensor of ``recv_like`` = (shape,
        dtype) (or None) comes in from stage - 1.  Returns (carry, token):
        the received tensor (None if nothing) and a new ordering token, a
        scalar that threads every hand-off of the rank into one chain (see
        ``_HandOff``)."""
        stage = self.stage_index()
        if x is not None and stage == self.pp - 1:
            raise ValueError("the last stage hands nothing on")
        if recv_like is not None and stage == 0:
            raise ValueError("stage 0 receives nothing")
        return _HandOff.apply(self, tick, recv_like, token, x)


class _HandOff(torch.autograd.Function):
    """One tick's stage hand-off, differentiable.

    ``apply(ctx, tick, recv_like, token, x)``.  Forward: ``x`` to stage + 1,
    the carry from stage - 1.  Backward, the transpose: the carry's
    gradient to stage - 1, ``x``'s gradient from stage + 1 (zeros where the
    carry got none).

    Each rank runs its own backward, so every hand-off a peer posts must be
    met here, in the same order.  ``token`` makes that so: each hand-off
    takes the previous one's token and returns the next, and the last token
    joins the rank's loss (``runner.attach_token``).  Every hand-off is then
    reached by the backward, whether or not its carry is used (stage 0's
    receives none, the last stage's sends none), and hand-off t's backward
    waits for hand-off t + 1's, on every rank alike."""

    @staticmethod
    def forward(fctx, ctx: Ctx, tick: int, recv_like, token, x):
        fctx.set_materialize_grads(False)
        rank = ctx.rank
        carry = ctx.exchange(x, rank + 1, recv_like, rank - 1, tag=tick)
        fctx.ctx, fctx.tick, fctx.recv_like = ctx, tick, recv_like
        fctx.x_like = None if x is None else (tuple(x.shape), x.dtype)
        return carry, token.detach().clone()

    @staticmethod
    def backward(fctx, g_carry, g_token):
        ctx, rank = fctx.ctx, fctx.ctx.rank
        send = None
        if fctx.recv_like is not None:
            shape, dtype = fctx.recv_like
            send = (g_carry if g_carry is not None
                    else torch.zeros(shape, dtype=dtype, device=ctx.device))
        g_x = ctx.exchange(send, rank - 1, fctx.x_like, rank + 1, tag=fctx.tick)
        if g_token is None:
            g_token = torch.zeros((), device=ctx.device)
        return None, None, None, g_token, g_x


SINGLE = Ctx()


def make_ctx(plan, *, device="cuda") -> Ctx:
    """The context of ``plan`` for this process: one device at dp x pp =
    1, else this rank of the initialised process group."""
    return Ctx(dp=plan.dp, pp=plan.pp, sp=plan.sp, device=device)
