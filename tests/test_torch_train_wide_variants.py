"""The wide training forms' design run
(``r2l_tpu_torch/exp/train_wide_variants.py``: K5's wide form and the
forward's), on the CPU: every variant's source edits still apply
to the kernels as built (each text once) and reach both libraries, the
copies differ from the sources only there, and the command line refuses
what it cannot do here. Its timing runs on a GPU only."""
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


@pytest.mark.parametrize("lib", ["LIB", "FWD_LIB"])
def test_variants_edit_what_the_library_builds(lib):
    """The edited header is one that K5's wide library and the forward's
    (the forward rows' variant builds) include."""
    name = getattr(V, lib)
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert name in _build.KERNELS
    assert all(f'#include "{f}"' in src for n in V.VARIANTS
               for f, _, _ in V.VARIANTS[n][0])


def test_forward_rows_run_every_layer_through_the_edited_passes():
    """The forward's every layer is a pass of the skeleton
    (``wideh::layer_pass``, which launches ``launch_pass``, whose epilogue
    and products the edits replace: bf16 and int8 through the
    shared-memory products, f32 through the TF32 ones of both sum routes)
    and none is the frame's retired mma.sync pass; the rows cover K3 bf16,
    K3 f32, K4 and K8."""
    src = (_build.CSRC / f"{V.FWD_LIB}.cu").read_text()
    head = (_build.CSRC / "wide_hopper.cuh").read_text()
    assert "wideh::layer_pass<C, Epi, kSplit>(" in src
    assert "return launch_pass<T, Epi, kSplit>(a, a, wm, om, p, e, stream);" \
        in head
    assert "r2lw::pass<" not in src and "wide_layer" not in src
    assert head.count("products_tf32<") >= 3   # one sum and the split route
    assert V.FWD_KINDS == ("k3_bf16", "k3_f32", "k4", "k8")


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
