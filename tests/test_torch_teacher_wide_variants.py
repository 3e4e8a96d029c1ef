"""The teacher's wide-form design run
(``r2l_tpu_torch/exp/teacher_wide_variants.py``), on the CPU: every
variant's source edits still apply to the kernel as built (each text
once), the copies differ from the sources only there, and a checkout
imported as a parent package stages and renders with its own modules, as
this checkout does. Its timing runs on a GPU only."""
import sys
from pathlib import Path

import pytest
import torch

from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import teacher_wide_variants as V
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import nerf_render as NR
from r2l_tpu_torch.models import NeRFConfig, init_nerf


@pytest.mark.parametrize("name", sorted(V.VARIANTS))
def test_variant_edits_apply_once(name, tmp_path):
    edits = V.VARIANTS[name][0]
    _harness.edited_sources(edits, _build.CSRC, tmp_path / name)
    for fname, text, repl in edits:
        src = (_build.CSRC / fname).read_text()
        got = (tmp_path / name / fname).read_text()
        assert src.count(text) == 1 and repl in got
        assert got.count(text) == (text in repl)
    untouched = {f for f, _, _ in edits}
    for f in _build.CSRC.iterdir():
        if f.name not in untouched:
            assert (tmp_path / name / f.name).read_bytes() == f.read_bytes()


def test_timing_needs_a_card():
    """Without a GPU the tool exits non-zero before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "noepi"])
    assert e.value.code == 1


def test_unknown_variants_are_refused():
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "noepi,nostage"])
    assert "nostage" in str(e.value.code)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_parent_package_runs_its_own_modules(wd):
    """This checkout imported as a parent package: its modules are its own
    (none of them this checkout's objects), its image of a W384 teacher is
    this checkout's byte for byte, and its plain version renders the same
    rgb, acc, depth and weights bit for bit."""
    name = "parent_r2l_tpu_torch_test"
    try:
        pkg = V.parent_package(_build.CSRC.parents[2], name)
        assert V.parent_package(".", name) is pkg
        from importlib import import_module
        PNR = import_module(name + ".kernels.nerf_render")
        assert PNR is not NR
        assert Path(PNR.__file__).resolve() == Path(NR.__file__).resolve()
        assert import_module(name + ".kernels._build") is not _build
        cfg = NeRFConfig(W=384, D=3, skips=(0,), compute_dtype=wd)
        model = init_nerf(cfg, torch.Generator().manual_seed(3),
                          torch.device("cpu"))
        fp = NR.prepare_fused_nerf(model, cfg, weight_dtype=wd)
        pfp = PNR.prepare_fused_nerf(model, cfg, weight_dtype=wd)
        assert torch.equal(fp.staged, pfp.staged)
        g = torch.Generator().manual_seed(4)
        o, d = torch.randn((5, 3), generator=g), torch.randn((5, 3),
                                                             generator=g)
        z = torch.sort(2.0 + 4.0 * torch.rand((5, 9), generator=g)).values
        for a, b in zip(NR.fused_nerf_render(fp, cfg, o, d, z),
                        PNR.fused_nerf_render(pfp, cfg, o, d, z)):
            assert torch.equal(a, b)
    finally:
        for mod in [m for m in sys.modules if m.startswith(name)]:
            del sys.modules[mod]
