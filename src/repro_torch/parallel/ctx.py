"""Parallel context over ``torch.distributed`` (port of ``repro/parallel/ctx.py``).

The reference's ``Ctx`` binds named mesh axes inside one SPMD program; here
each rank is a process of its own and ``Ctx`` holds the process groups of a
3-D layout (DESIGN.md §4): ``pods`` (pure data parallelism, the outermost
axis) times ``dp x pp`` data ranks (stage-major: data index ``d`` runs
pipeline stage ``d % pp`` of dp group ``d // pp``) times ``sp`` model
ranks, model-minor: rank = (pod x dp x pp + data_index) x sp +
model_index, so the ranks of one model group are neighbours.

The data axis, at each model index, with the pod sum added where the
reference adds it (its ``ctx.py:112-139``):

- ``psum_grads``: the stage's gradients over its dp group and the pods
  (the ranks of the same stage and model index), ``_dp_groups``;
- ``psum_globals``: the globals' gradients, whose contributions live on
  different stages: a leaf that one stage alone uses (the embedding, the
  head) is summed over that stage's dp groups of every pod and sent from
  there to the other stages of the same pod and model index, the rest
  summed over the data axis of every pod;
- ``psum_loss_all``: over the data axis and the pods (every model rank
  holds the same replicated loss, so the model axis is not summed);
- ``psum_stages``: over the stages of one dp group;
- ``handoff``: the pipeline's stage hand-off (the reference's
  ``ppermute_stage`` along ``next_stage_perm``) as a differentiable
  exchange: this stage's output goes to stage + 1 of the same model index
  and stage - 1's comes in, posted together as one ``batch_isend_irecv``;
  its backward is the transpose.

The model axis (the reference's ``ctx.py:59-101``): ``psum_model``,
``pmax_model``, ``all_gather_model``, ``all_gather_param`` and
``reduce_scatter_model`` over the ranks of one model group.  Each is a
``torch.autograd.Function`` whose backward is its transpose under one
convention: every rank differentiates the same replicated scalar loss.  So
an all-gather's backward is a reduce-scatter and the other way round, the
max is gradient-frozen (the reference's ``stop_gradient``s), and a psum
whose result is replicated downstream passes its cotangent through
unchanged.  That last is where the port departs from the reference, whose
``shard_map`` runs with ``check_vma=False``: there a psum transposes to a
psum, which scales every all-gathered leaf's gradient by sp, and no
replicated ("rep") leaf's gradient is summed over the model axis.  The port
computes the gradient of the global loss (``parallel/runner.py``, PERF.md
§6).  Under ``grad_compress`` the weight gather's backward
reduce-scatters in bf16 (the reference's ``_ag_bf16_grad``).
``ppermute_model`` (ring attention's KV rotation, ``parallel/ring.py``)
sends each rank's tensors along a permutation of the model group, one
``batch_isend_irecv``; its backward sends the cotangents along the inverse
permutation (no sp factor: the loss every rank holds is the global one).
``all_to_all_model`` (expert parallelism, ``models/moe.py``) cuts a
tensor into sp parts, sends part j to rank j and concatenates what comes
in; its backward sends the cotangent's parts back the same way.  The pod
axis carries ZeRO-1's gather of the updated parameter
slices (``all_gather_pod``).  ``SINGLE`` is the one-device context: every
reduction is the identity.

The backend is the process group's, named by whoever started it
(``launch.mesh``), never picked here.  ``"nccl"`` needs a CUDA device of
its own for every rank of the host and raises otherwise.  ``"gloo"`` has no
CUDA collectives: with CUDA tensors every hand-off, reduction and model
collective is staged explicitly through pinned host buffers (a synchronous
D2H, the transfer, an H2D), which is how several ranks share one card.  The
context counts what it moves (``counts()``): its exchanges (``handoffs``,
forward and backward alike) with the bytes it sent and their host seconds,
the seconds of the hand-offs' staging copies among them, its all-reduces'
bytes (``reduce_*`` over the data axis, ``model_reduce_*`` the replicated
leaves' gradients over the model group), the globals' bytes it sent to
other stages (``bcast_bytes``), and, per model collective (``model_all_gather``,
``model_reduce_scatter``, ``model_psum``, ``model_pmax``,
``model_all_to_all``), its calls, the bytes this rank put in (its shard
for a gather, the whole tensor for the others, what it sent for a
permutation) and its seconds, staging included; ``model_ppermute`` and
``model_all_to_all`` count forward and backward alike,
``pod_all_gather`` the ZeRO-1 gathers the same way, and
``data_all_gather`` serving's gather of the decoded tokens over the data
axis (``all_gather_data``).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch

BACKENDS = ("gloo", "nccl")
MODEL_COLLECTIVES = ("model_all_gather", "model_reduce_scatter", "model_psum", "model_pmax",
                     "model_ppermute", "model_all_to_all")
# the plan's attention schedules at sp > 1 (models/attention.py)
ATTN_MODES = ("gather_q", "gather_kv", "auto", "ring", "local")


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
    """One rank of ``pods`` times ``dp`` groups of ``pp`` stages times ``sp``
    model ranks.

    At ``pods x dp x pp x sp = 1`` the single-device context (``SINGLE``):
    every reduction is the identity and nothing is exchanged.  Over several ranks
    it takes the initialised process group's rank and backend; ``device``
    is where this rank's tensors live.  ``attn_mode``, ``merge_bf16`` and
    ``grad_compress`` are the plan's knobs of the model axis, as in the
    reference."""

    def __init__(self, *, dp: int = 1, pp: int = 1, sp: int = 1, pods: int = 1, device="cuda",
                 attn_mode: str = "gather_q", merge_bf16: bool = False,
                 grad_compress: bool = False):
        if attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode {attn_mode!r}: expected one of {ATTN_MODES}")
        if attn_mode == "local" and sp > 1:
            raise ValueError("attn_mode 'local' moves no KV between model ranks: sp = 1 only")
        self.dp, self.pp, self.sp, self.pods, self.rank = dp, pp, sp, pods, 0
        self.attn_mode, self.merge_bf16, self.grad_compress = attn_mode, merge_bf16, grad_compress
        self.backend = None
        self.device = torch.device(device)
        self._dp_group = self._stage_group = self._model_group = self._data_group = None
        self._pod_group = None
        self._counts = {}
        self.reset_counts()
        if self.world == 1:
            return
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(f"pods x dp x pp x sp = {self.world} ranks need an initialised "
                               "process group (launch.mesh.init_from_env or launch.mesh.spawn)")
        if dist.get_world_size() != self.world:
            raise ValueError(f"pods x dp x pp x sp = {pods} x {dp} x {pp} x {sp} does not match "
                             f"the process group's {dist.get_world_size()} ranks")
        self.rank, self.backend = dist.get_rank(), dist.get_backend()
        check_backend(self.backend, self.device,
                      int(os.environ.get("LOCAL_WORLD_SIZE", self.world)))
        # every rank creates every group, in the same order (new_group is
        # collective); each keeps its own
        for attr, groups in (("_dp_group", self._dp_groups()),
                             ("_stage_group", self._stage_rows()),
                             ("_model_group", self._model_groups()),
                             ("_data_group", self._data_groups()),
                             ("_pod_group", self._pod_groups())):
            for group in groups:
                # a group of the whole world (the data axis at sp = 1, say)
                # is the default group
                g = (dist.new_group(group) if 1 < len(group) < self.world
                     else None)
                if self.rank in group:
                    setattr(self, attr, g)

    # ----- sizes / indices -------------------------------------------------
    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def world(self) -> int:
        return self.pods * self.dp * self.pp * self.sp

    def model_index(self) -> int:
        return self.rank % self.sp

    def data_index(self) -> int:
        """The rank's index on the data axis of its pod."""
        return (self.rank // self.sp) % (self.dp * self.pp)

    def pod_index(self) -> int:
        return self.rank // (self.sp * self.dp * self.pp)

    def stage_index(self) -> int:
        """Pipeline stage of this rank: data_index % pp (stage-major)."""
        return self.data_index() % self.pp

    def dp_index(self) -> int:
        return self.data_index() // self.pp

    def rank_of(self, data_index: int, model_index: Optional[int] = None,
                pod: Optional[int] = None) -> int:
        """The rank at ``data_index``, ``model_index`` and ``pod`` (this
        rank's by default)."""
        m = self.model_index() if model_index is None else model_index
        p = self.pod_index() if pod is None else pod
        return (p * self.dp * self.pp + data_index) * self.sp + m

    def _dp_groups(self):
        """The ranks of each stage and model index across the dp groups and
        the pods (the reference's ``axis_index_groups`` of ``psum_grads``
        and its pod sum, in one group)."""
        return [[self.rank_of(g * self.pp + s, m, p) for p in range(self.pods)
                 for g in range(self.dp)]
                for s in range(self.pp) for m in range(self.sp)]

    def _stage_rows(self):
        """The stages of each dp group at each model index (``psum_stages``'
        grouping)."""
        return [[self.rank_of(g * self.pp + s, m, p) for s in range(self.pp)]
                for p in range(self.pods) for g in range(self.dp) for m in range(self.sp)]

    def _model_groups(self):
        """The model ranks of each data index."""
        return [[self.rank_of(d, m, p) for m in range(self.sp)]
                for p in range(self.pods) for d in range(self.dp * self.pp)]

    def _data_groups(self):
        """The data axis of every pod at each model index."""
        return [[self.rank_of(d, m, p) for p in range(self.pods) for d in range(self.dp * self.pp)]
                for m in range(self.sp)]

    def _pod_groups(self):
        """The pods' ranks of each data and model index."""
        return [[self.rank_of(d, m, p) for p in range(self.pods)]
                for d in range(self.dp * self.pp) for m in range(self.sp)]

    # ----- counters --------------------------------------------------------
    def counts(self) -> dict:
        return dict(self._counts)

    def reset_counts(self) -> None:
        self._counts.update(handoffs=0, handoff_bytes=0, handoff_s=0.0, staging_s=0.0,
                            reduce_bytes=0, bcast_bytes=0, reduce_s=0.0,
                            model_reduce_bytes=0, model_reduce_s=0.0)
        for kind in (*MODEL_COLLECTIVES, "pod_all_gather", "data_all_gather"):
            self._counts.update({f"{kind}_calls": 0, f"{kind}_bytes": 0, f"{kind}_s": 0.0})

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

    def _all_reduce(self, tensors: Sequence[torch.Tensor], group, key: str = "reduce") -> None:
        """Sum ``tensors`` in place over ``group``: one all-reduce per dtype
        over a flat buffer of its tensors (staged through pinned host memory
        under gloo with CUDA tensors), counted under ``key``."""
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
            self._counts[f"{key}_bytes"] += flat.numel() * flat.element_size()
        self._counts[f"{key}_s"] += time.perf_counter() - t_start

    def _send_from_owners(self, by_owner: dict) -> None:
        """In place: ``by_owner[s]``, the leaves that stage s alone holds
        the sum of, go from stage s to the other stages of this rank's dp
        group at its model index; every send and receive posted together,
        one flat buffer per owner and dtype."""
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
                            ops.append(dist.P2POp(dist.isend, flat, self.rank_of(row + peer),
                                                  tag=tag))
                            self._counts["bcast_bytes"] += flat.numel() * flat.element_size()
                else:
                    buf = torch.empty(sum(t.numel() for t in ts), dtype=ts[0].dtype,
                                      pin_memory=staged,
                                      device="cpu" if staged else self.device)
                    ops.append(dist.P2POp(dist.irecv, buf, self.rank_of(row + s), tag=tag))
                    recvs.append((buf, ts))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for buf, ts in recvs:
            self._unflatten(buf.to(self.device), ts)
        self._counts["reduce_s"] += time.perf_counter() - t_start

    def psum_grads(self, tensors) -> None:
        """In place: gradient reduction across the dp replicas of this stage
        and the pods (at this model index)."""
        if self.distributed and self.dp * self.pods > 1:
            self._all_reduce(list(tensors), self._dp_group)

    def psum_model_grads(self, tensors) -> None:
        """In place: the replicated ("rep") leaves' gradients summed over
        the model group: each model rank differentiated its own sequence
        shard through the same leaf."""
        if self.distributed and self.sp > 1:
            tensors = list(tensors)
            if tensors:
                self._all_reduce(tensors, self._model_group, key="model_reduce")

    def psum_globals(self, tensors, used: Optional[Sequence[bool]] = None) -> None:
        """In place: the global parameters' gradients summed over the data
        axis and the pods at this model index (their contributions live on
        different stages).

        ``used[i]`` says whether ``tensors[i]``'s gradient came out of this
        rank's graph (default: all of them).  A leaf that one stage alone
        uses (at pp > 1 the embedding on stage 0, the final norm and the
        head on the last) is summed over that stage's dp groups of every
        pod and sent from there to the other stages of each dp group: each
        stage sends what it owns and receives the rest, where an all-reduce
        would move every leaf twice and add the other stages' zeros.  A leaf
        that several stages use (a tied embedding) is all-reduced over the
        data axis of every pod.  Every rank learns which stages use what
        from one small all-reduce, so that all split the leaves alike."""
        if not (self.distributed and self.dp * self.pp * self.pods > 1):
            return
        tensors = list(tensors)
        if not tensors:
            return
        mask = torch.zeros((self.pp, len(tensors)), dtype=torch.int32, device=self.device)
        mask[self.stage_index()] = torch.tensor(
            [True] * len(tensors) if used is None else list(used), dtype=torch.int32)
        self._all_reduce([mask], self._data_group)
        rows = mask.tolist()
        owners = [[s for s in range(self.pp) if rows[s][i]] for i in range(len(tensors))]
        shared = [t for t, o in zip(tensors, owners) if len(o) > 1]
        if shared:
            self._all_reduce(shared, self._data_group)
        by_owner = {s: [t for t, o in zip(tensors, owners) if o == [s]] for s in range(self.pp)}
        self.psum_grads(by_owner[self.stage_index()])
        self._send_from_owners({s: ts for s, ts in by_owner.items() if ts})

    def psum_loss_all(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar summed over the data axis and the pods (a new tensor, no
        gradient): the model ranks of a data index hold the same replicated
        value."""
        x = x.detach().clone()
        if self.distributed and self.dp * self.pp * self.pods > 1:
            self._all_reduce([x], self._data_group)
        return x

    def psum_all(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar summed over every rank: the data axis, the pods and the
        model axis (a new tensor, no gradient), for a value each rank
        computed over its own rows alone (the MoE balance loss, the
        reference's ``psum_loss_all`` of it)."""
        x = x.detach().clone()
        if self.distributed:
            self._all_reduce([x], None)
        return x

    def psum_stages(self, tensors) -> None:
        """In place: a sum over the pipeline stages of this rank's dp group
        at its model index (the reference replicates the last stage's
        sampled decode tokens with it)."""
        if self.distributed and self.pp > 1:
            self._all_reduce(list(tensors), self._stage_group)

    def all_gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``x`` at this model index, stacked on a new
        leading dim in data-index order ([pods x dp x pp, *x.shape]; no gradient):
        serving's one gather of the decoded tokens at the end of a run
        (``launch/serve.py``), staged through pinned host memory under gloo
        with CUDA tensors, counted as ``data_all_gather``."""
        if not (self.distributed and self.dp * self.pp * self.pods > 1):
            return x[None]
        import torch.distributed as dist

        t_start = time.perf_counter()
        n = self.dp * self.pp * self.pods
        src, staged = x.contiguous(), self._staged()
        if staged:
            src = torch.empty(src.shape, dtype=src.dtype, pin_memory=True).copy_(src)
        out = torch.empty((n * src.numel(),), dtype=src.dtype, device=src.device,
                          pin_memory=staged)
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, src.reshape(-1), group=self._data_group)
        self._counts["data_all_gather_calls"] += 1
        self._counts["data_all_gather_bytes"] += src.numel() * src.element_size()
        self._counts["data_all_gather_s"] += time.perf_counter() - t_start
        return out.to(self.device).view(n, *x.shape)

    def barrier(self) -> None:
        if self.distributed:
            import torch.distributed as dist

            dist.barrier()

    # ----- the model axis --------------------------------------------------
    def _model_op(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        """One collective of the model group on ``x`` (a new tensor):
        ``model_all_gather`` concatenates the ranks' ``x`` along dim 0,
        ``model_reduce_scatter`` sums them and keeps this rank's 1 / sp of
        dim 0, ``model_psum`` / ``model_pmax`` sum or take the max.  Staged
        through pinned host memory under gloo with CUDA tensors."""
        import torch.distributed as dist

        t_start = time.perf_counter()
        sp, group = self.sp, self._model_group
        x = x.contiguous()
        staged = self._staged()
        if staged:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            x = host.copy_(x)

        def empty(shape):
            return torch.empty(shape, dtype=x.dtype, device=x.device, pin_memory=staged)

        if kind == "model_all_gather":
            out = empty((sp * x.shape[0], *x.shape[1:]))
            _collective("all_gather_single", "all_gather_into_tensor")(out, x, group=group)
        elif kind == "model_reduce_scatter":
            if x.shape[0] % sp:
                raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {sp} ranks")
            out = empty((x.shape[0] // sp, *x.shape[1:]))
            _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, x, group=group)
        else:
            out = x if staged else x.clone()
            op = dist.ReduceOp.MAX if kind == "model_pmax" else dist.ReduceOp.SUM
            dist.all_reduce(out, op=op, group=group)
        if staged:
            out = out.to(self.device)
        self._counts[f"{kind}_calls"] += 1
        self._counts[f"{kind}_bytes"] += x.numel() * x.element_size()
        self._counts[f"{kind}_s"] += time.perf_counter() - t_start
        return out

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` (no gradient)."""
        if self.sp == 1:
            return x
        return self._model_op("model_all_gather", x.movedim(dim, 0)).movedim(0, dim)

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` summed, this rank's 1 / sp of ``dim`` (no
        gradient)."""
        if self.sp == 1:
            return x
        return self._model_op("model_reduce_scatter", x.movedim(dim, 0)).movedim(0, dim)

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model group of a value replicated downstream: the
        backward passes the cotangent through unchanged."""
        if self.sp == 1:
            return x
        return _PsumReplicated.apply(self, x)

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the model group, gradient-frozen."""
        if self.sp == 1:
            return x.detach()
        return self._model_op("model_pmax", x.detach())

    def all_gather_model(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Gather shards along ``axis`` (tiled: sp x the local dim); the
        backward reduce-scatters."""
        if self.sp == 1:
            return x
        return _AllGather.apply(self, axis, False, x)

    def all_gather_param(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """A weight's gather for compute; under ``grad_compress`` its
        backward (the weight gradient's reduce-scatter, the dominant train
        collective) runs in bf16 (reference ``_ag_bf16_grad``)."""
        if self.sp == 1:
            return x
        return _AllGather.apply(self, axis, self.grad_compress, x)

    def reduce_scatter_model(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Sum over the model group, this rank's 1 / sp of ``axis``; the
        backward all-gathers."""
        if self.sp == 1:
            return x
        return _ReduceScatter.apply(self, axis, x)

    def ppermute_model(self, x, perm, *, pending: Optional[list] = None):
        """``x`` (a tensor, or a tuple of tensors sent together) along
        ``perm``, (source, destination) pairs of model indices: this rank
        sends to its destination and receives from its source, every tensor
        posted in one ``batch_isend_irecv`` (zeros where no rank sends to
        this one).  Differentiable in the floating tensors (``_Permute``):
        the backward sends their cotangents along the inverse permutation.
        ``pending``, a list: under NCCL the forward's transfer is left in
        flight, its handles appended there, and the caller must ``wait``
        on them before the received tensors are read (the ring posts its
        next hop before its kernel call so); staged through host memory
        under gloo, the transfer is done when this returns."""
        if self.sp == 1:
            return x
        xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
        out = _Permute.apply(self, tuple(perm), pending, *xs)
        return out[0] if isinstance(x, torch.Tensor) else out

    @staticmethod
    def wait(pending: list) -> None:
        """Wait on (and drop) the handles ``ppermute_model`` left in
        ``pending``."""
        for work in pending:
            work.wait()
        pending.clear()

    def _peers(self, perm):
        """(rank this one sends to, rank it receives from) under ``perm``
        (model indices), None where it has none."""
        m = self.model_index()
        to = [d for s, d in perm if s == m]
        frm = [s for s, d in perm if d == m]
        if len(to) > 1 or len(frm) > 1:
            raise ValueError(f"{list(perm)} is not a permutation of the model group")
        return (self.rank_of(self.data_index(), to[0]) if to else None,
                self.rank_of(self.data_index(), frm[0]) if frm else None)

    def _permute(self, xs, to, frm, pending=None):
        """``xs`` to rank ``to``, their likes from rank ``frm`` (zeros where
        ``frm`` is None), counted as ``model_ppermute``."""
        if self._staged():
            torch.cuda.current_stream(self.device).synchronize()
        t_start = time.perf_counter()
        likes = [(tuple(x.shape), x.dtype) for x in xs]
        got, nbytes, _ = self._p2p(xs if to is not None else [], to,
                                   likes if frm is not None else [], frm, pending=pending)
        if frm is None:
            got = [torch.zeros(s, dtype=d, device=self.device) for s, d in likes]
        self._counts["model_ppermute_calls"] += 1
        self._counts["model_ppermute_bytes"] += nbytes
        self._counts["model_ppermute_s"] += time.perf_counter() - t_start
        return got

    def all_gather_pod(self, params, dims) -> None:
        """ZeRO-1's gather, in place: of each ``params[i]`` this rank
        updated slice ``pod_index`` of ``pods`` equal parts along
        ``dims[i]`` (``optim/adamw.py``'s ``PodSlices``); every pod's slices
        are gathered into the others, one all-gather of a flat buffer per
        dtype over the pod group (staged through pinned host memory under
        gloo with CUDA tensors), counted as ``pod_all_gather``."""
        if not (self.distributed and self.pods > 1):
            return
        t_start = time.perf_counter()
        me, staged = self.pod_index(), self._staged()

        def part(p, d, pod):
            n = p.shape[d] // self.pods
            return p.narrow(d, pod * n, n)

        by_dtype = {}
        for p, d in zip(params, dims):
            by_dtype.setdefault(p.dtype, []).append((p, d))
        for group in by_dtype.values():
            mine = [part(p, d, me) for p, d in group]
            flat = torch.cat([t.reshape(-1) for t in mine])
            if staged:
                flat = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True).copy_(flat)
            out = torch.empty(self.pods * flat.numel(), dtype=flat.dtype, device=flat.device,
                              pin_memory=staged)
            _collective("all_gather_single", "all_gather_into_tensor")(
                out, flat, group=self._pod_group)
            out = out.to(self.device).view(self.pods, -1)
            for pod in range(self.pods):
                if pod != me:
                    pieces = out[pod].split([t.numel() for t in mine])
                    for (p, d), t, piece in zip(group, mine, pieces):
                        part(p, d, pod).copy_(piece.view(t.shape))
            self._counts["pod_all_gather_calls"] += 1
            self._counts["pod_all_gather_bytes"] += flat.numel() * flat.element_size()
        self._counts["pod_all_gather_s"] += time.perf_counter() - t_start

    def all_to_all_model(self, x: torch.Tensor, split_axis: int, concat_axis: int):
        """The tiled all-to-all of expert parallelism (the reference's
        ``jax.lax.all_to_all(..., tiled=True)``): ``x`` is cut into sp
        equal parts along ``split_axis``, part j goes to model rank j, and
        the parts received are concatenated along ``concat_axis`` in source
        order.  Differentiable in a floating ``x`` (``_AllToAll``: the
        backward is the all-to-all with the axes swapped); an integer ``x``
        (the expert ids) passes without a gradient.  Staged through pinned
        host memory under gloo with CUDA tensors, counted as
        ``model_all_to_all`` (calls, the bytes this rank put in, seconds)."""
        if self.sp == 1:
            return x
        if not x.is_floating_point():
            return self._all_to_all(x, split_axis, concat_axis)
        return _AllToAll.apply(self, split_axis, concat_axis, x)

    def _all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int):
        import torch.distributed as dist

        sp = self.sp
        if x.shape[split_axis] % sp:
            raise ValueError(f"all-to-all of {x.shape[split_axis]} rows over {sp} ranks")
        t_start = time.perf_counter()
        parts = x.movedim(split_axis, 0)
        inp = parts.reshape(sp, parts.shape[0] // sp, *parts.shape[1:]).contiguous()
        staged = self._staged()
        if staged:
            inp = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True).copy_(inp)
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=self._model_group)
        if staged:
            out = out.to(self.device)
        self._counts["model_all_to_all_calls"] += 1
        self._counts["model_all_to_all_bytes"] += inp.numel() * inp.element_size()
        self._counts["model_all_to_all_s"] += time.perf_counter() - t_start
        return torch.cat([piece.movedim(0, split_axis) for piece in out.unbind(0)],
                         dim=concat_axis)

    # ----- point to point ---------------------------------------------------
    def _p2p(self, sends, to, recv_likes, frm, *, tag: int = 0, pending=None):
        """Post ``sends`` to rank ``to`` and receives of ``recv_likes``
        ((shape, dtype) each) from rank ``frm`` as one ``batch_isend_irecv``,
        the i-th of each side under tag ``tag + i``.  Returns (the received tensors on
        this rank's device, bytes sent, staging seconds).  Under gloo with
        CUDA tensors both sides are staged through pinned host memory (the
        caller has synchronized the stream); else, with ``pending`` given,
        the transfer's handles are appended there unwaited (``wait``)."""
        import torch.distributed as dist

        staged = self._staged()
        t0 = time.perf_counter()
        ops, bufs, nbytes = [], [], 0
        for i, t in enumerate(sends):
            buf = t.detach().contiguous()
            if staged:
                buf = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True).copy_(buf)
            ops.append(dist.P2POp(dist.isend, buf, to, tag=tag + i))
            nbytes += buf.numel() * buf.element_size()
        for i, (shape, dtype) in enumerate(recv_likes):
            buf = torch.empty(shape, dtype=dtype, pin_memory=staged,
                              device="cpu" if staged else self.device)
            ops.append(dist.P2POp(dist.irecv, buf, frm, tag=tag + i))
            bufs.append(buf)
        staging = time.perf_counter() - t0
        works = dist.batch_isend_irecv(ops) if ops else []
        if pending is not None and not staged:
            pending.extend(works)
        else:
            for work in works:
                work.wait()
        if staged and bufs:
            t0 = time.perf_counter()
            bufs = [b.to(self.device) for b in bufs]
            staging += time.perf_counter() - t0
        return bufs, nbytes, staging

    # ----- the stage hand-off ----------------------------------------------
    def exchange(self, send: Optional[torch.Tensor], to: Optional[int],
                 recv_like: Optional[tuple], frm: Optional[int], tag: int):
        """Send ``send`` to rank ``to`` and receive a tensor of ``recv_like``
        = (shape, dtype) from rank ``frm``, posted together under ``tag``;
        either side may be None.  Returns the received tensor on this rank's
        device (None where nothing was received)."""
        if send is None and recv_like is None:
            return None
        if self._staged():
            # the staging copies wait for the work queued on the stream:
            # wait here, so that their time is the copies' own
            torch.cuda.current_stream(self.device).synchronize()
        t_start = time.perf_counter()
        got, nbytes, staging = self._p2p([] if send is None else [send], to,
                                         [] if recv_like is None else [recv_like], frm,
                                         tag=tag)
        self._counts["handoffs"] += 1
        self._counts["handoff_bytes"] += nbytes
        self._counts["staging_s"] += staging
        self._counts["handoff_s"] += time.perf_counter() - t_start
        return got[0] if got else None

    def handoff(self, x: Optional[torch.Tensor], recv_like: Optional[tuple],
                token: torch.Tensor, tick: int):
        """The stage hand-off of tick ``tick``: ``x`` (this stage's output,
        or None) goes to stage + 1, and a tensor of ``recv_like`` = (shape,
        dtype) (or None) comes in from stage - 1, both at this rank's model
        index.  Returns (carry, token): the received tensor (None if
        nothing) and a new ordering token, a scalar that threads every
        hand-off of the rank into one chain (see ``_HandOff``)."""
        stage = self.stage_index()
        if x is not None and stage == self.pp - 1:
            raise ValueError("the last stage hands nothing on")
        if recv_like is not None and stage == 0:
            raise ValueError("stage 0 receives nothing")
        return _HandOff.apply(self, tick, recv_like, token, x)


def _collective(name: str, older: str):
    """``torch.distributed``'s ``name``, or its older spelling ``older``
    where this torch predates it."""
    import torch.distributed as dist

    return getattr(dist, name, None) or getattr(dist, older)


class _AllGather(torch.autograd.Function):
    """``apply(ctx, dim, compress, x)``: the tiled all-gather along ``dim``;
    backward, the reduce-scatter of the cotangent (in bf16 under
    ``compress``, cast back to x's dtype)."""

    @staticmethod
    def forward(fctx, ctx: Ctx, dim: int, compress: bool, x):
        fctx.ctx, fctx.dim, fctx.compress, fctx.dtype = ctx, dim, compress, x.dtype
        return ctx.gather(x, dim)

    @staticmethod
    def backward(fctx, g):
        if fctx.compress:
            g = g.to(torch.bfloat16)
        return None, None, None, fctx.ctx.scatter_sum(g, fctx.dim).to(fctx.dtype)


class _ReduceScatter(torch.autograd.Function):
    """``apply(ctx, dim, x)``: the sum over the model group, this rank's
    slice of ``dim``; backward, the all-gather of the cotangent."""

    @staticmethod
    def forward(fctx, ctx: Ctx, dim: int, x):
        fctx.ctx, fctx.dim = ctx, dim
        return ctx.scatter_sum(x, dim)

    @staticmethod
    def backward(fctx, g):
        return None, None, fctx.ctx.gather(g.contiguous(), fctx.dim)


class _Permute(torch.autograd.Function):
    """``apply(ctx, perm, pending, *xs)``: ``xs`` sent along ``perm`` over
    the model group (``Ctx.ppermute_model``); backward, the floating
    tensors' cotangents along the inverse permutation (to the rank this one
    received from, from the rank it sent to), zeros sent for a cotangent
    autograd did not produce, so that the peer's receive is always met.
    The integer tensors (positions) get no gradient and are not sent back.
    Each rank runs its own backward: its permutations' backward meet the
    peers' in the order autograd reaches them, the same on every rank of
    one program."""

    @staticmethod
    def forward(fctx, ctx: Ctx, perm, pending, *xs):
        fctx.set_materialize_grads(False)
        to, frm = ctx._peers(perm)
        fctx.ctx, fctx.peers = ctx, (to, frm)
        fctx.likes = [(tuple(x.shape), x.dtype) for x in xs]
        out = ctx._permute(xs, to, frm, pending)
        fctx.mark_non_differentiable(*[t for t in out if not t.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(fctx, *gs):
        ctx, (to, frm) = fctx.ctx, fctx.peers
        flo = [i for i, (_, dtype) in enumerate(fctx.likes) if dtype.is_floating_point]
        sends = [gs[i] if gs[i] is not None
                 else torch.zeros(fctx.likes[i][0], dtype=fctx.likes[i][1], device=ctx.device)
                 for i in flo]
        back = ctx._permute(sends, frm, to)
        grads = [None] * len(fctx.likes)
        for i, g in zip(flo, back):
            grads[i] = g
        return (None, None, None, *grads)


class _AllToAll(torch.autograd.Function):
    """``apply(ctx, split_axis, concat_axis, x)``: the tiled all-to-all
    over the model group; backward, the all-to-all of the cotangent with
    the axes swapped (its transpose: the parts go back to where they came
    from)."""

    @staticmethod
    def forward(fctx, ctx: Ctx, split_axis: int, concat_axis: int, x):
        fctx.ctx, fctx.axes = ctx, (split_axis, concat_axis)
        return ctx._all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(fctx, g):
        split_axis, concat_axis = fctx.axes
        return None, None, None, fctx.ctx._all_to_all(g, concat_axis, split_axis)


class _PsumReplicated(torch.autograd.Function):
    """``apply(ctx, x)``: the sum over the model group of a value every
    rank then uses alike; the backward is the identity (each rank holds the
    cotangent of the same replicated loss)."""

    @staticmethod
    def forward(fctx, ctx: Ctx, x):
        return ctx._model_op("model_psum", x)

    @staticmethod
    def backward(fctx, g):
        return None, g


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
        nxt, prv = ctx.rank + ctx.sp, ctx.rank - ctx.sp
        carry = ctx.exchange(x, nxt, recv_like, prv, tag=tick)
        fctx.ctx, fctx.tick, fctx.recv_like = ctx, tick, recv_like
        fctx.x_like = None if x is None else (tuple(x.shape), x.dtype)
        return carry, token.detach().clone()

    @staticmethod
    def backward(fctx, g_carry, g_token):
        ctx = fctx.ctx
        send = None
        if fctx.recv_like is not None:
            shape, dtype = fctx.recv_like
            send = (g_carry if g_carry is not None
                    else torch.zeros(shape, dtype=dtype, device=ctx.device))
        g_x = ctx.exchange(send, ctx.rank - ctx.sp, fctx.x_like, ctx.rank + ctx.sp,
                           tag=fctx.tick)
        if g_token is None:
            g_token = torch.zeros((), device=ctx.device)
        return None, None, None, g_token, g_x


SINGLE = Ctx()


def make_ctx(plan, *, pods: int = 1, device="cuda") -> Ctx:
    """The context of ``plan`` over ``pods`` pods for this process: one
    device at pods x dp x pp x sp = 1, else this rank of the initialised
    process group."""
    return Ctx(dp=plan.dp, pp=plan.pp, sp=plan.sp, pods=pods, device=device,
               attn_mode=plan.attn_mode, merge_bf16=plan.merge_bf16,
               grad_compress=plan.grad_compress)
