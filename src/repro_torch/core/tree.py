"""Nested dicts and lists of tensors: the port's parameter, gradient and
optimizer-moment trees (the reference's pytrees)."""
from __future__ import annotations


def items(tree, prefix: str = ""):
    """(path, leaf) pairs in order: dict keys in insertion order, list
    entries by index; paths join the keys with '/' (``stages/0/attn/wq``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map_(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of that shape."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
