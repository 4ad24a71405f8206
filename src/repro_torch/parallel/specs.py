"""ZeRO-1's moment layout over the pod axis (the widening rule of
``repro/parallel/specs.py::opt_specs``, DESIGN.md §4, §11).

The reference realizes ZeRO-1 as a sharding: with ``zero1_pod`` each
leaf's moments are sharded over ('model', 'pod') at its shard marker's dim
(an "ag" or "keepN" leaf) when that dim of the whole leaf divides by
sp x pods, and keep the parameter's own sharding otherwise (the replicated
leaves, and the small vectors that do not divide).  The port keeps the
same moments by hand: each rank holds slice ``pod_index`` of ``pods``
equal parts of its model shard's moments along that dim, updates that
slice of the parameter, and the pods gather the updated slices
(``optim/adamw.py::PodSlices``, ``Ctx.all_gather_pod``).  The update is
elementwise, so the parameters are the same bits as without ZeRO-1.
"""
from __future__ import annotations

from repro_torch.core import tree
from repro_torch.models.model_zoo import marker_dim, param_markers


def zero1_dims(mdef, params, sp: int, pods: int) -> list:
    """For each leaf of ``params`` (this model rank's shards of a stage's
    slots and the globals, in ``tree.leaves`` order): the dim along which
    its moments are split over the pods, or None where they stay whole.
    A leaf is widened when it has a model-sharded dim whose full size (sp
    x the shard's) divides by sp x pods."""
    out = []
    for t, mark in zip(tree.leaves(params), tree.leaves(param_markers(mdef, params))):
        d = marker_dim(mark)
        out.append(d if d is not None and (t.shape[d] * sp) % (sp * pods) == 0 else None)
    return out
