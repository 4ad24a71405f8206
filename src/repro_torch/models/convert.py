"""Carry parameters across from the JAX reference.

``params_from_numpy`` takes the reference's ``{"stages": ..., "globals": ...}``
pytree as nested dicts of numpy arrays, in its names and layouts, with the
leading slot dim on every stage leaf (``ModelDef.init_stage_params`` at
pp = 1), and returns the port's parameters: the same globals, and the stage
as a list of per-slot dicts.

The caller passes float32 arrays: ``np.asarray`` of a JAX bf16 array is an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses.  The cast to
the model dtype happens here, on the torch side, and is exact for values
that came from bf16.  The slot gate stays float32, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, name: str, dtype, device):
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"{name}: expected a float32 array, got {a.dtype}")
    dt = torch.float32 if name.endswith("gate") else dtype
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dt)


def _map(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(tree, prefix.rstrip("/"))


def params_from_numpy(tree, *, dtype=torch.bfloat16, device="cuda"):
    stages = tree["stages"]
    n_slots = {np.shape(a)[0] for a in _leaves(stages)}
    if len(n_slots) != 1:
        raise ValueError(f"stage leaves disagree on the slot dim: {n_slots}")
    slots = [_map(stages, lambda a, name, i=i: _tensor(a[i], name, dtype, device))
             for i in range(n_slots.pop())]
    glob = _map(tree["globals"], lambda a, name: _tensor(a, name, dtype, device))
    return {"stages": slots, "globals": glob}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
