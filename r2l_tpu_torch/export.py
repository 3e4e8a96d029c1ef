"""ONNX export of the R2L student, with the reference's parity check.

Counterpart of ``r2l_tpu/export.py::export_onnx`` (:168-255), the reference's
``save_onnx`` and ``check_onnx`` (reference ``main.py:831-885``): opset 11,
a dynamic batch axis, checked at ``rtol=1e-3, atol=1e-5``. The port's
``R2L`` is the torch module that ``r2l_tpu`` rebuilds for this
(``build_torch_r2l``), so it is exported as it is, as an f32 copy on the
CPU. The StableHLO, SavedModel and TFLite artefacts of ``r2l_tpu/export.py``
(:33, 258, 358) are JAX and TensorFlow formats and are not ported.
"""
from __future__ import annotations

import dataclasses
import importlib
import os

import numpy as np
import torch

from .models.r2l import R2L, R2LConfig, params_to_jax
from .onnx_writer import build_r2l_onnx, run_onnx

RTOL, ATOL = 1e-3, 1e-5  # the reference's tolerances (`main.py:879-882`)


def _importable(name: str):
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def export_onnx(model: R2L, cfg: R2LConfig, out_dir: str,
                sample_batch: int = 4096, log=print,
                generator: torch.Generator | None = None) -> str:
    """Write ``<out_dir>/r2l.onnx`` and check it; returns the path.

    The graph is the full-precision forward (the reference exports its f32
    model; a bf16 graph could not meet the check's tolerances): an f32 copy
    of ``model`` on the CPU. It is serialized by torch's exporter where the
    ``onnx`` package imports, else by the native writer
    (``onnx_writer.build_r2l_onnx``), and the log says which. The check runs
    the file on min(sample_batch, 256) normal inputs drawn from
    ``generator`` (a CPU generator seeded with 0 by default) with
    onnxruntime where it imports, else with ``onnx_writer.run_onnx``, against
    the module's own output."""
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    module = R2L(cfg32, "cpu").eval()
    with torch.no_grad():
        module.load_state_dict({k: v.detach().float().cpu()
                                for k, v in model.state_dict().items()})
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    x = torch.randn((min(sample_batch, 256), cfg32.input_dim), generator=g,
                    device=g.device).cpu()
    with torch.no_grad():
        want = module(x).numpy()

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "r2l.onnx")
    provenance = None
    if _importable("onnx") is not None:
        try:
            torch.onnx.export(module, (torch.zeros(1, cfg32.input_dim),),
                              path, opset_version=11, input_names=["input"],
                              output_names=["rgb"],
                              dynamic_axes={"input": {0: "batch"},
                                            "rgb": {0: "batch"}},
                              dynamo=False)
            provenance = "torch exporter"
        except Exception as e:   # the exporter's errors have no common type
            log(f"[export] torch's exporter failed ({e}); using the "
                "native writer")
    if provenance is None:
        with open(path, "wb") as f:
            f.write(build_r2l_onnx(params_to_jax(module, cfg32), cfg32))
        provenance = ("native writer (torch's exporter needs the 'onnx' "
                      "package, not installed here)")

    ort = _importable("onnxruntime")
    if ort is None:
        with open(path, "rb") as f:
            got = run_onnx(f.read(), x.numpy())
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        log(f"[export] wrote {path} via {provenance} (in-repo ONNX "
            f"evaluator parity check passed at rtol={RTOL}/atol={ATOL}; "
            "install onnxruntime to also run the reference's runtime "
            "check, `main.py:857-885`)")
        return path
    sess = ort.InferenceSession(path, providers=["CPUExecutionProvider"])
    got = sess.run(["rgb"], {"input": x.numpy()})[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    log(f"[export] wrote {path} via {provenance} (onnxruntime parity "
        "check passed)")
    return path
