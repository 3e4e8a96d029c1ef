"""Ports of the JAX package's ``exp/`` probe kernels: tensor-core ceilings of
the engines K1 and K2 run, measured on the H100.

* ``probe_mxu`` (``exp/probe_mxu.py``): the 86-layer W256 chain with a full,
  lean or no epilogue, as two warp groups in flight (``dual``), at N=512
  (``bigN``) and in static-scale int8;
* ``probe_shapes`` (``exp/probe_shapes.py``): 64 products by (M, K, N) shape
  and dtype, unchained or chained;
* ``_harness``: their timing protocol and JSON-line records.

Run on a GPU: ``python -m r2l_tpu_torch.exp.probe_mxu [quick] [--out
PATH]`` and ``python -m r2l_tpu_torch.exp.probe_shapes [--out PATH]``.
The records go to stdout and to ``--out``; the JAX probes' logs under
``exp/`` are the reference's and are never written.
"""
