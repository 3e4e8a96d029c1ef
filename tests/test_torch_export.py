"""Port parity of the ONNX export (r2l_tpu_torch/onnx_writer.py,
r2l_tpu_torch/export.py) against r2l_tpu/onnx_writer.py and
r2l_tpu/export.py::export_onnx.

The native writer's file is held byte for byte to JAX's for the same tree
(the same protobuf fields in the same order). The file's evaluator and
``export_onnx``'s check run at the reference's tolerances, rtol 1e-3 and
atol 1e-5 (reference ``main.py:879-882``, ``r2l_tpu/export.py:30``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import models, n, np_tree
from r2l_tpu import onnx_writer as JOW
from r2l_tpu.models import R2LConfig as JaxR2LConfig
from r2l_tpu.models import apply_r2l
from r2l_tpu_torch import export as EX
from r2l_tpu_torch import onnx_writer as OW
from r2l_tpu_torch.models import params_to_jax

RTOL, ATOL = 1e-3, 1e-5
ARCHS = {
    "resmlp": {},
    "mlp": {"body_arch": "mlp"},
    "lrelu_res_scale": {"act": "lrelu", "inact": "lrelu", "outact": "relu",
                        "res_scale": 0.5},
    "linear_tail_no_residual": {"linear_tail": True,
                                "use_residual": False},
}


def _case(arch, **kw):
    """(JAX cfg, JAX params, port cfg, port model), the same weights."""
    jcfg = JaxR2LConfig(input_dim=6 * 9, netwidth=32, netdepth=8,
                        precision="highest", **ARCHS[arch], **kw)
    return (jcfg, *models(jcfg, seed=3))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_build_r2l_onnx_bytes_equal_jax(arch):
    """The port's graph of ``params_to_jax(model)`` is JAX's graph of the
    JAX params, byte for byte."""
    jcfg, params, cfg, model = _case(arch)
    want = JOW.build_r2l_onnx(params, jcfg)
    assert OW.build_r2l_onnx(params_to_jax(model, cfg), cfg) == want
    assert OW.build_r2l_onnx(np_tree(params), cfg) == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_run_onnx_matches_port_forward(arch):
    _, params, cfg, model = _case(arch)
    blob = OW.build_r2l_onnx(params_to_jax(model, cfg), cfg)
    x = np.random.default_rng(4).normal(size=(64, cfg.input_dim)) \
        .astype(np.float32)
    with torch.no_grad():
        want = n(model(torch.from_numpy(x)))
    np.testing.assert_allclose(OW.run_onnx(blob, x), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(OW.run_onnx(blob, x), JOW.run_onnx(blob, x),
                               rtol=0, atol=0)


def _no_onnx(monkeypatch):
    """As if neither ``onnx`` nor ``onnxruntime`` were installed (neither is
    here; the patch keeps the test so where they are)."""
    real = EX._importable
    monkeypatch.setattr(EX, "_importable", lambda name: None if name in (
        "onnx", "onnxruntime") else real(name))


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_export_onnx_writes_and_checks(compute_dtype, monkeypatch,
                                       tmp_path):
    """``export_onnx`` with ``onnx`` absent: the native writer's file, the
    f32 graph whatever the model's compute dtype, checked by ``run_onnx``;
    the log says which serializer and which check."""
    _no_onnx(monkeypatch)
    jcfg, params, cfg, model = _case(
        "resmlp", compute_dtype=jnp.bfloat16 if compute_dtype == "bf16"
        else jnp.float32)
    log = []
    path = EX.export_onnx(model, cfg, str(tmp_path), log=log.append)
    assert path == str(tmp_path / "r2l.onnx")
    assert any("native writer" in m and "parity check passed" in m
               for m in log), log
    with open(path, "rb") as f:
        blob = f.read()
    assert blob == OW.build_r2l_onnx(np_tree(params), dataclasses.replace(
        cfg, compute_dtype=torch.float32))
    x = torch.randn((256, cfg.input_dim),
                    generator=torch.Generator().manual_seed(0)).numpy()
    jcfg32 = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v: apply_r2l(params, jcfg32, v))(x))
    np.testing.assert_allclose(OW.run_onnx(blob, x), want, rtol=RTOL,
                               atol=ATOL)


def test_export_onnx_check_catches_a_wrong_graph(monkeypatch, tmp_path):
    """A graph that does not compute the module's function fails the
    check."""
    _no_onnx(monkeypatch)
    _, params, cfg, model = _case("resmlp")

    def wrong(p, c):
        p["tail"]["b"] = p["tail"]["b"] + 0.1
        return OW.build_r2l_onnx(p, c)
    monkeypatch.setattr(EX, "build_r2l_onnx", wrong)
    with pytest.raises(AssertionError):
        EX.export_onnx(model, cfg, str(tmp_path), log=lambda s: None)
