"""The map between a model's state_dict and the JAX package's param pytree,
and host copies of such trees.

A table lists, for each parameter of the module, its state_dict name, its
path in the JAX pytree and, for the ResMLP body that JAX stacks
``[n_block, n_learnable, ...]``, its index in that stack. Weights are
``[out, in]`` in torch and ``[in, out]`` in JAX, so every 2-d leaf is
transposed on the way. One table serves the parameters and anything shaped
like them: Adam's moments go through the same map.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Entry(NamedTuple):
    name: str           # state_dict name, e.g. "body.3.body.2.weight"
    path: tuple         # JAX pytree path, e.g. ("body", "w")
    index: tuple = ()   # position in a stacked leaf, e.g. (3, 1)


def linear(name: str, path: tuple, index: tuple = ()) -> list[Entry]:
    """A Linear's two entries: weight at ``path + ("w",)``, bias at
    ``path + ("b",)``."""
    return [Entry(f"{name}.weight", path + ("w",), index),
            Entry(f"{name}.bias", path + ("b",), index)]


def _transposed(a, weight: bool):
    return a.T if weight and a.ndim == 2 else a


def from_jax(tree: dict, table: list[Entry]) -> dict:
    """JAX pytree -> {state_dict name: leaf} (leaves as the tree holds them,
    numpy or torch, weights transposed; lists may be lists or dicts with
    "0", "1", ... keys, as a checkpoint file stores them)."""
    out = {}
    for e in table:
        a = tree
        for k in e.path:
            a = a[str(k)] if isinstance(k, int) and isinstance(a, dict) \
                else a[k]
        if e.index:
            a = a[e.index]
        out[e.name] = _transposed(a, e.name.endswith(".weight"))
    return out


def named(model: torch.nn.Module) -> dict:
    """{state_dict name: parameter}, detached."""
    return {k: p.detach() for k, p in model.named_parameters()}


def to_jax(tensors: dict, table: list[Entry]) -> dict:
    """{state_dict name: tensor} -> the JAX pytree of tensors: weights
    transposed, stacked leaves stacked, int path keys as lists."""
    flat: dict = {}
    for e in table:
        t = _transposed(tensors[e.name], e.name.endswith(".weight"))
        if e.index:
            flat.setdefault(e.path, {})[e.index] = t
        else:
            flat[e.path] = t
    tree: dict = {}
    for path, v in flat.items():
        if isinstance(v, dict):                 # a stacked leaf
            v = _stack(v)
        keys = [str(k) if isinstance(k, int) else k for k in path]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return restore_lists(tree)


def _stack(parts: dict):
    """{(i, j): leaf} -> leaf stacked [n_i, n_j, ...]."""
    ni = 1 + max(i for i, _ in parts)
    nj = 1 + max(j for _, j in parts)
    first = next(iter(parts.values()))
    stack = torch.stack if isinstance(first, torch.Tensor) else np.stack
    return stack([stack([parts[(i, j)] for j in range(nj)])
                  for i in range(ni)])


def restore_lists(node):
    """A checkpoint's tree with every dict keyed "0".."n-1" as a list (the
    file keeps a list as such a dict; flax restores it against a target)."""
    if not isinstance(node, dict):
        return node
    node = {k: restore_lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int64: np.int64,
              torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8,
              torch.bool: np.bool_}


def map_tree(tree, fn):
    """``fn`` on every leaf of dicts, lists, tuples and NamedTuples; None
    stays None (an empty subtree, as in JAX)."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def _gather(tensors: list) -> list:
    """Host numpy copies of ``tensors``: the card's in one transfer per
    device (one synchronisation), not one per tensor."""
    out: list = [None] * len(tensors)
    by_dev: dict = {}
    for i, t in enumerate(tensors):
        if t.dtype not in _NP_DTYPES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        by_dev.setdefault(t.device, []).append(i)
    for dev, ids in by_dev.items():
        flat = [tensors[i].detach().reshape(-1).view(torch.uint8)
                for i in ids]
        host = torch.cat(flat).cpu().numpy() if dev.type != "cpu" else None
        off = 0
        for i, f in zip(ids, flat):
            t = tensors[i]
            raw = host[off:off + f.numel()] if host is not None \
                else f.numpy().copy()
            off += f.numel()
            out[i] = raw.view(_NP_DTYPES[t.dtype]).reshape(tuple(t.shape))
    return out


def host_tree(tree):
    """``tree`` with every leaf a numpy array, as ``jax.tree.map(np.asarray,
    tree)`` gives it; its tensors are copied to the host by ``_gather``."""
    tensors: list = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return x
        return np.asarray(x)

    skeleton = map_tree(tree, collect)
    arrays = iter(_gather(tensors))
    return map_tree(skeleton, lambda x: next(arrays)
                    if isinstance(x, torch.Tensor) else x)
