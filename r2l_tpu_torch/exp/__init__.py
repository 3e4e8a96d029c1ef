"""Ports of the JAX package's ``exp/`` probe kernels: tensor-core ceilings of
the engines K1 and K2 run, and K2's int8 body, epilogue and streams,
measured on the H100.

* ``probe_mxu`` (``exp/probe_mxu.py``): the 86-layer W256 chain with a full,
  lean or no epilogue, as two warp groups in flight (``dual``), at N=512
  (``bigN``) and in static-scale int8;
* ``probe_shapes`` (``exp/probe_shapes.py``): 64 products by (M, K, N) shape
  and dtype, unchained or chained;
* ``probe_int8`` (``exp/probe_int8.py``): K2's int8 ResMLP body with static
  scales, its requantize folded, two tiles in flight, and a bf16 control;
* ``probe_wall`` (``exp/probe_wall.py``): the bare int8 product rate, a
  minimal cast, and the realistic epilogue;
* ``probe_pipe_lib`` and its driver ``probe_pipe`` (``exp/probe_pipe*.py``):
  K2 with each ray tile split into S streams;
* ``probe_epi`` (``exp/probe_epi.py``): K2 with three requantize epilogues;
* ``_harness``: their timing protocols, bounds and JSON-line records.

Run on a GPU: ``python -m r2l_tpu_torch.exp.<probe> [--out PATH]`` for
``probe_mxu`` (also ``quick``), ``probe_shapes``, ``probe_int8``,
``probe_wall``, ``probe_pipe`` and ``probe_epi``. The records go to stdout
and to ``--out``; the JAX probes' logs under ``exp/`` are the reference's
and are never written.
"""
