"""The port never imports JAX: a fresh interpreter imports r2l_tpu_torch and
every module in it, renders a frame on the CPU through each kind, and finds
no ``jax`` in sys.modules."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np, torch
torch.set_num_threads(1)
import r2l_tpu_torch
names = [m.name for m in pkgutil.walk_packages(r2l_tpu_torch.__path__,
                                               "r2l_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from r2l_tpu_torch.evaluate import make_r2l_frame_fn
from r2l_tpu_torch.models import R2LConfig, init_r2l
from r2l_tpu_torch.rays import pose_spherical
from r2l_tpu_torch.sampler import PointSampler
cfg = R2LConfig(input_dim=6 * 21, netdepth=6, netwidth=64,
                compute_dtype=torch.bfloat16)
model = init_r2l(cfg, torch.Generator().manual_seed(0))
sampler = PointSampler(H=4, W=4, focal=5.0, n_sample=2, near=2.0, far=6.0)
poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4] for t in (0, 90)])
for kw in ({"use_pallas": False}, {}, {"quantize": "int8"}):
    assert make_r2l_frame_fn(model, cfg, sampler, calib_poses=poses,
                             **kw)(poses[0]).shape == (4, 4, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 10 and bad.strip() == "[]"


def test_port_sources_name_no_jax_import():
    """No ``import jax`` / ``from jax`` line anywhere in the package."""
    pkg = os.path.join(REPO, "r2l_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for ln in fh:
                        s = ln.strip()
                        assert not s.startswith(("import jax",
                                                 "from jax")), (f, s)
