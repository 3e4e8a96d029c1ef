"""The student frame's wide form's design run
(``r2l_tpu_torch/exp/frame_wide_variants.py``: K1, K9 and K2 above W256),
on the CPU: every variant's source edits still apply to the kernels as
built (each text once) and reach the frame's wide library, the copies
differ from the sources only there, every layer of the frame runs through
the edited passes, and the command line refuses what it cannot do here.
Its timing runs on a GPU only."""
import re

import pytest
import torch

from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import frame_wide_variants as V
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
    """The edited header is one that the frame's wide library includes."""
    src = (_build.CSRC / f"{V.LIB}.cu").read_text()
    assert V.LIB in _build.KERNELS
    assert all(f'#include "{f}"' in src for n in V.VARIANTS
               for f, _, _ in V.VARIANTS[n][0])


def test_frame_rows_run_every_layer_through_the_edited_passes():
    """The frame's every layer is a pass of the skeleton
    (``wideh::layer_pass``, which launches ``wideh::launch_pass``, whose
    epilogue and products the edits replace: bf16 and int8 through the
    shared-memory products, f32 through the TF32 ones) with the frame's
    epilogues, the head and the body layers alike, and none is the retired
    mma.sync pass, which the shared header no longer holds; the rows cover
    K1 bf16 and f32, K9 bf16 and f32, K2's three forms and K1 bf16 at
    W384/D44."""
    src = (_build.CSRC / f"{V.LIB}.cu").read_text()
    shared = (_build.CSRC / "r2l_wide.cuh").read_text()
    head = (_build.CSRC / "wide_hopper.cuh").read_text()
    assert "return launch_pass<T, Epi, kSplit>(a, a, wm, om, p, e, stream);" \
        in head
    assert "using Epi = wideh::TrainK3<C, true>;" in src
    assert "using Epi = wideh::FrameK2;" in src
    for call in (r"wideh::layer_pass<C, Epi, kSplit>\(\s*a, [^,]+, n, W, "
                 r"(kp|W),",
                 r"wideh::layer_pass<int8_t, Epi>\(\s*a, [^,]+, n, W, "
                 r"(kp|W),"):
        assert re.findall(call, src) == ["kp", "W"], call  # head, layers
    for text in ("r2lw::pass<", "wide_layer", "mma_step", "ldsm_x4",
                 "mma.sync", "cp_async"):
        assert text not in src and text not in shared, text
    assert re.findall(r"constexpr int kF32Split = (\d+);", src) == ["0"]
    assert [k for k, _, _ in V.ROWS] == [
        "k1_bf16", "k1_f32", "k9_bf16", "k9_f32", "k2_deployed", "k2_fold",
        "k2_unfolded", "k1_bf16_w384"]


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
