"""Freeze the inputs of the int8 epilogue canary for the PyTorch port.

``tests/fixtures/int8_epilogue_canary.npz`` holds the canary's output
(``tools/gen_int8_epilogue_canary.py``). Its weights come from JAX's PRNG,
which PyTorch cannot reproduce, so this script writes the case itself (the
parameter pytree, the calibration points and the rendered points of
``build_case``) to ``tests/fixtures/int8_epilogue_canary_case.npz``. The
port's int8 path is then held to the canary without importing JAX, on the
CPU (``tests/test_torch_kernel_int8.py``) and on the GPU (``chip_smoke.py``).

Run on CPU:
    python tools/gen_int8_canary_case.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "int8_epilogue_canary_case.npz")


def case_arrays() -> dict:
    """``build_case`` as flat numpy arrays (weights [in, out], as in JAX)."""
    from tools.gen_int8_epilogue_canary import build_case
    _, params, calib, pts = build_case()
    return {"head_w": params["head"]["w"], "head_b": params["head"]["b"],
            "body_w": params["body"]["w"], "body_b": params["body"]["b"],
            "tail_w": params["tail"]["w"], "tail_b": params["tail"]["b"],
            "calib": calib, "pts": pts}


def main():
    arrays = {k: np.asarray(v, np.float32) for k, v in case_arrays().items()}
    np.savez(OUT, **arrays)
    print("wrote", OUT, {k: v.shape for k, v in arrays.items()})


if __name__ == "__main__":
    main()
