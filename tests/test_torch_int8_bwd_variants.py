"""K2's and K5's design alternatives
(``r2l_tpu_torch/exp/int8_bwd_variants.py``), on the CPU: every variant's
source edits still apply to the kernels as built (each text once), and the
copies differ from the sources only there. Their timing runs on a GPU
only."""
import pytest
import torch

from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import int8_bwd_variants as V
from r2l_tpu_torch.kernels import _build


@pytest.mark.parametrize("name", sorted(V.VARIANTS))
def test_variant_edits_apply_once(name, tmp_path):
    """Each edit's text occurs once in the sources and the copy differs
    from them only where the edits say."""
    _harness.edited_sources(V.VARIANTS[name][0], _build.CSRC,
                            tmp_path / name)
    for fname, text, repl in V.VARIANTS[name][0]:
        src = (_build.CSRC / fname).read_text()
        got = (tmp_path / name / fname).read_text()
        assert src.count(text) == 1 and repl in got
    untouched = {f for f, _, _ in V.VARIANTS[name][0]}
    for f in _build.CSRC.iterdir():
        if f.name not in untouched:
            assert (tmp_path / name / f.name).read_bytes() == f.read_bytes()
    assert V.LIBS[V.VARIANTS[name][1]] in _build.KERNELS


def test_timing_needs_a_card():
    """Without a GPU the tool exits non-zero before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        V.main(["--variants", "k2_cvt"])
    assert e.value.code == 1


@pytest.mark.parametrize("tool", ["int8_bwd_variants", "chain_variants"])
def test_parent_check_needs_a_card(tool):
    """``--parent TREE`` (this checkout's K1/K9 or K2 held bit for bit to a
    parent's build) exits non-zero without a GPU, before it builds
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from r2l_tpu_torch.exp import chain_variants as CV
    mod = V if tool == "int8_bwd_variants" else CV
    with pytest.raises(SystemExit) as e:
        mod.main(["--parent", "no-such-tree"])
    assert e.value.code == 1


def test_an_edit_that_does_not_apply_is_refused(tmp_path):
    """A text that no longer occurs exactly once stops the copy."""
    with pytest.raises(ValueError, match="0 copies"):
        _harness.edited_sources([(V.K2, "no such text", "")], _build.CSRC,
                                tmp_path / "v")


def test_loading_swaps_every_library_and_restores_the_build():
    """Inside ``loading`` every library loads as the variant's; after it,
    and after an error inside it, the build's loader is back."""
    keep = _build.load
    with _harness.loading("variant"):
        assert _build.load("r2l_bwd_group") == "variant"
        assert _build.load("r2l_int8_hopper") == "variant"
    assert _build.load is keep
    with pytest.raises(RuntimeError):
        with _harness.loading("variant"):
            raise RuntimeError
    assert _build.load is keep


def test_steps_script_times_the_four_kinds():
    """The steps script (shared by both tools) compiles and names the four
    distillation kinds of chip_smoke.py's phase 6, and ``fused`` at the
    CLI's default f32."""
    compile(_harness._STEPS, "<steps>", "exec")
    for kind in ("xla", "fused", "fused_int8", "fused_int8_bf16stash",
                 "fused_f32"):
        assert f'("{kind}",' in _harness._STEPS
