"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the ``r2l_tpu``
function on JAX CPU and the ``r2l_tpu_torch`` function on torch CPU, and
compares the two with a stated tolerance. Torch is capped at two threads:
tier-1 runs six test workers on eight cores.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models import init_r2l as jax_init_r2l
from r2l_tpu_torch.models import R2L, R2LConfig, params_from_jax

torch.set_num_threads(2)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def torch_cfg(jcfg: JaxR2LConfig) -> R2LConfig:
    """The port's config for a JAX config (``precision`` has no
    counterpart; ``compute_dtype`` becomes a torch dtype)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(R2LConfig)}
    fields["compute_dtype"] = _DTYPES[jcfg.compute_dtype]
    return R2LConfig(**fields)


def np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def models(jcfg: JaxR2LConfig, seed: int = 0):
    """(JAX params, port cfg, port model) with the same weights."""
    params = jax_init_r2l(jax.random.key(seed), jcfg)
    cfg = torch_cfg(jcfg)
    model = R2L(cfg)
    model.load_state_dict(params_from_jax(np_tree(params), cfg))
    return params, cfg, model


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def kernel_layout(name: str, jax_field, like: torch.Tensor) -> np.ndarray:
    """A JAX kernel-layout field in the port's kernel layout: weights
    (``*_w``, ``*_q``) transposed to [out, in], 1-d biases and scales, and
    the JAX 128-lane padding cut to the port's shape (the port pads the
    head's input to a multiple of 128 as well, with the same zeros)."""
    a = np.asarray(jax_field)
    if name.endswith(("_w", "_q")):
        a = np.swapaxes(a, -1, -2)
    if a.ndim == 2 and a.shape[0] == 1 and like.ndim == 1:
        a = a[0]
    return a[tuple(slice(0, s) for s in like.shape)]

