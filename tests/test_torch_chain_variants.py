"""K1's design alternatives (``r2l_tpu_torch/exp/chain_variants.py``), on
the CPU: every variant's source edits still apply to the chain as built
(each text once), and the image each variant stages unpacks to the packed
fields. Their timing runs on a GPU only."""
import pytest
import torch

from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import chain_variants as CV
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels.staging import tf32_split
from r2l_tpu_torch.models import R2LConfig, init_r2l


@pytest.mark.parametrize("name", sorted(CV.VARIANTS))
def test_variant_edits_apply_once(name, tmp_path):
    """Each edit's text occurs once in the sources and the copy differs
    from them only where the edits say."""
    _harness.edited_sources(CV.VARIANTS[name][0], _build.CSRC,
                            tmp_path / name)
    for fname, text, repl in CV.VARIANTS[name][0]:
        src = (_build.CSRC / fname).read_text()
        got = (tmp_path / name / fname).read_text()
        assert src.count(text) == 1 and repl in got
    untouched = {f for f, _, _ in CV.VARIANTS[name][0]}
    for f in _build.CSRC.iterdir():
        if f.name not in untouched:
            assert (tmp_path / name / f.name).read_bytes() == f.read_bytes()


@pytest.mark.parametrize("name", ["slots6"])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_variant_stage_width_stages_the_same_weights(name, wd, monkeypatch):
    """A variant's narrower stages hold the same weights: its image unpacks
    bit for bit to the packed fields (f32: their TF32 split)."""
    k, _ = CV.VARIANTS[name][1][wd]
    monkeypatch.setitem(F.CHAIN_STAGE_K, wd, k)
    cfg = R2LConfig(input_dim=12 * 21, netdepth=8, netwidth=128,
                    compute_dtype=wd)
    model = init_r2l(cfg, torch.Generator().manual_seed(1), "cpu")
    fp = F.prepare_fused_params_pe(model, cfg, 12, 10, weight_dtype=wd)
    assert F.chain_stage_plan(cfg, wd)["stage_k"] == k
    got = F.unstage_chain_weights(fp.staged, cfg, wd)
    for field in ("head_w", "body_w"):
        want = getattr(fp, field)
        parts = tf32_split(want) if wd == torch.float32 else (want,)
        for part, suffix in zip(parts, ("", "_lo")):
            assert torch.equal(got[field + suffix].view(torch.uint8),
                               part.contiguous().view(torch.uint8))


def test_timing_needs_a_card():
    """Without a GPU the tool exits non-zero before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        CV.main(["--variants", "c4"])
    assert e.value.code == 1


def test_timing_only_variants_keep_the_last_block():
    """noepi and nomma skip the epilogues of every block but the last: the
    edited branch opens with the blocks' test, then the original one."""
    assert CV.NO_HIDDEN_EPI == ("      if (blk + 1 < a.nb) {\n      } else "
                                "if (j + 1 < a.nl) {  // inner layer: "
                                "ReLU, round, into T")
