"""K5 wide's design run (``r2l_tpu_torch/exp/train_wide_variants.py``), on
the CPU: every variant's source edits still apply to the kernel as built
(each text once), the copies differ from the sources only there, and the
command line refuses what it cannot do here. Its timing runs on a GPU
only."""
import pytest
import torch

from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import train_wide_variants as V
from r2l_tpu_torch.kernels import _build


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


def test_variants_edit_what_the_library_builds():
    """The edited header is one K5's wide library includes."""
    src = (_build.CSRC / f"{V.LIB}.cu").read_text()
    assert V.LIB in _build.KERNELS
    assert all(f'#include "{f}"' in src for name in V.VARIANTS
               for f, _, _ in V.VARIANTS[name][0])


def test_timing_needs_a_card():
    """Without a GPU the tool exits non-zero before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "noepi"])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        V.main(["--parent", "."])
    assert e.value.code == 1


def test_unknown_variants_are_refused():
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "noepi,nostage"])
    assert "nostage" in str(e.value.code)
