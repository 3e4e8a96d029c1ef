"""Run the port's multi-process CPU cases (``tests/_torch_mesh_worker.py``)
on N gloo ranks from a test: the inputs go in one ``.npz``, each rank's
outputs come back per case. The ranks meet through a file (no TCP port,
so parallel test workers cannot collide), run one intra-op thread each,
and are joined with a timeout and killed on expiry, so a hang fails the
test instead of holding the suite. ``counted_collectives`` counts the
collectives a block issues (the one-rank tests)."""
from __future__ import annotations

import collections
import contextlib
import os
import sys
from unittest import mock

import numpy as np

from r2l_tpu_torch.parallel.dist import spawn_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 240


def flat(tree, prefix: str) -> dict:
    """A nested dict/list of arrays (a JAX parameter tree) as
    {'prefix/a/0/b': array}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def listify(node):
    """Dicts keyed 0..n-1 back into lists (``flat``'s inverse)."""
    if not isinstance(node, dict):
        return node
    node = {k: listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflat(d: dict, prefix: str):
    out: dict = {}
    for k, v in d.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return listify(out)


def run_ranks(n: int, cases: dict, tmp: str) -> dict:
    """Run each case of ``cases`` (name -> {input name: array}) on n ranks.
    Returns name -> [rank 0's outputs, rank 1's, ...] (dicts of arrays), or
    name -> the first rank's error text."""
    os.makedirs(tmp, exist_ok=True)
    blob = {f"{c}/{k}": np.asarray(v) for c, kv in cases.items()
            for k, v in kv.items()}
    blob.setdefault("_", np.zeros(1))
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **blob)
    rc = spawn_ranks([sys.executable,
                      os.path.join(HERE, "_torch_mesh_worker.py"), inputs,
                      tmp] + list(cases), n, timeout=TIMEOUT_S)
    out = {}
    for c in cases:
        ranks = []
        for r in range(n):
            stem = os.path.join(tmp, f"{c}_r{r}")
            if os.path.exists(stem + ".err"):
                with open(stem + ".err") as f:
                    ranks = f"rank {r}: " + f.read()
                break
            if not os.path.exists(stem + ".npz"):
                ranks = f"rank {r} wrote nothing (ranks' exit code {rc})"
                break
            with np.load(stem + ".npz") as z:
                ranks.append(dict(z))
        out[c] = ranks
    return out


def ok(result) -> list:
    """A case's per-rank outputs; fails the test with the rank's error."""
    if isinstance(result, str):
        raise AssertionError(result)
    return result


@contextlib.contextmanager
def counted_collectives():
    """The ``torch.distributed`` collectives issued inside the block, by
    name (the mesh helpers call them through the module)."""
    import torch.distributed as dist
    calls = collections.Counter()

    def wrap(name, real):
        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return call

    with mock.patch.multiple(dist, **{
            k: wrap(k, getattr(dist, k))
            for k in ("all_gather", "all_reduce", "broadcast")}):
        yield calls
