"""The shape probe kernel's split runs
(``r2l_tpu_torch/exp/shape_variants.py``), on the CPU: every variant's
source edits still apply to the kernel as built (each text once), and the
copies differ from the sources only there. Their timing runs on a GPU
only."""
import pytest
import torch

from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import shape_variants as V
from r2l_tpu_torch.kernels import _build


@pytest.mark.parametrize("name", sorted(V.VARIANTS))
def test_variant_edits_apply_once(name, tmp_path):
    edits = V.VARIANTS[name]
    _harness.edited_sources(edits, _build.CSRC, tmp_path / name)
    for fname, text, repl in edits:
        src = (_build.CSRC / fname).read_text()
        got = (tmp_path / name / fname).read_text()
        assert src.count(text) == 1 and repl in got
    untouched = {f for f, _, _ in edits}
    for f in _build.CSRC.iterdir():
        if f.name not in untouched:
            assert (tmp_path / name / f.name).read_bytes() == f.read_bytes()


def test_timing_needs_a_card():
    """Without a GPU the tool exits non-zero before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "ring_only"])
    assert e.value.code == 1


def test_unknown_variants_are_refused():
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "ring_only,pingpong"])
    assert e.value.code == 2
