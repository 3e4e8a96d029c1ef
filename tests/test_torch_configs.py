"""Port parity: the command line and config files
(r2l_tpu_torch/configs.py against r2l_tpu/configs.py)."""
import dataclasses
import glob
import os

import jax.numpy as jnp
import pytest
import torch

import r2l_tpu.configs as JC
from r2l_tpu_torch import configs as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.txt")))

ARGVS = {
    "defaults": [],
    "readme_student": ("--model_name R2L --config configs/lego_noview.txt "
                       "--n_sample_per_ray 16 --netwidth 256 --netdepth 88 "
                       "--use_residual --trial.ON --trial.body_arch resmlp "
                       "--render_only --render_test --pretrained_ckpt x"),
    "distill_flags": ("--hard_ratio 0.2 --hard_mul 20 --warmup_lr "
                      "0.0001,200 --N_rand 20 --data_mode rays "
                      "--fused_train_vjp --fused_train_int8 "
                      "--compute_dtype bfloat16 --quantize int8"),
    "hard_pair_and_lists": ("--hard_ratio 0.1,0.2 --n_pose_kd 4,2,1 "
                            "--n_pose_video fix:90,3,1"),
    "trial_and_sl": ("--trial.ON --trial.n_block 5 --trial.res_scale 0.5 "
                     "--trial.inact lrelu --sl.ON --trial.near 1.5"),
    "bools_and_store_false": ("--no_batching 0 --white_bkgd true "
                              "--no_rand_focal --use_pallas false "
                              "--save_testset 0"),
    "config_then_cli_wins": "--config configs/fern.txt --N_rand 64",
    "create_data": ("--create_data convert_rays --splits train,val "
                    "--ignore 1,3 --donerf --datadir_kd a:b"),
}


def _vars(ns):
    """vars() with the trial namespace compared by its fields."""
    out = dict(vars(ns))
    if "trial" in out:
        out["trial"] = dict(vars(out["trial"]))
    return out


def _both(argv):
    return JC.parse_args(argv), TC.parse_args(argv)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_files_parse_alike(path):
    assert len(CONFIGS) == 57
    j, t = _both(["--config", path])
    assert _vars(t) == _vars(j)


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_argv_parse_alike(name, monkeypatch):
    monkeypatch.chdir(REPO)
    argv = ARGVS[name]
    argv = argv.split() if isinstance(argv, str) else argv
    j, t = _both(argv)
    assert _vars(t) == _vars(j)


@pytest.mark.parametrize("argv", [
    "--dataset_type nope", "--hard_ratio", "--n_pose_kd 40.0",
    "--n_pose_kd 4,2", "--platform gpu"])
def test_bad_flags_exit_alike(argv):
    for mod in (JC, TC):
        with pytest.raises(SystemExit):
            mod.parse_args(argv.split())


def test_unknown_config_key_exits(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("netwidth = 64\nnot_a_flag = 3\n")
    with pytest.raises(SystemExit, match="not_a_flag"):
        TC.parse_args(["--config", str(p)])


@pytest.mark.parametrize("argv", [
    "--netwidth 64 --netdepth 12 --use_residual --trial.ON "
    "--trial.body_arch resmlp --n_sample_per_ray 8",
    "--compute_dtype bfloat16 --learn_depth surface --linear_tail "
    "--act lrelu",
    "--plucker --trial.ON --trial.n_block 3 --trial.n_learnable 3",
    "--layerwise_netwidths 64,32,32 --netdepth 5",
])
def test_r2l_config_alike(argv):
    j, t = _both(argv.split())
    jc, tc = JC.args_to_r2l_config(j), TC.args_to_r2l_config(t)
    for f in dataclasses.fields(tc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "compute_dtype":
            assert b == {jnp.float32: torch.float32,
                         jnp.bfloat16: torch.bfloat16}[a]
        else:
            assert b == a, f.name


def test_mesh_spec_alike():
    for spec in ("", "data:8", "data:4,model:2", "data"):
        assert TC.parse_mesh_spec(spec) == JC.parse_mesh_spec(spec)


def test_flops_match_jax():
    """The parameter-based counts on the port's modules against the JAX
    package's on the same architectures' pytrees (the student of the
    README's flags at a shallower depth, and lego's teacher)."""
    import jax

    import r2l_tpu.app as japp
    import r2l_tpu.flops as JF
    from r2l_tpu_torch import flops as TF
    from r2l_tpu_torch.models import init_nerf, init_r2l
    argv = ("--netwidth 64 --netdepth 12 --use_residual --trial.ON "
            "--trial.body_arch resmlp --n_sample_per_ray 16").split()
    j, t = _both(argv)
    jcfg, tcfg = JC.args_to_r2l_config(j), TC.args_to_r2l_config(t)
    params = japp.init_r2l(jax.random.key(0), jcfg)
    model = init_r2l(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert TF.count_params(model) == JF.count_params(params)
    assert TF.param_bytes(model) == JF.param_bytes(params)
    assert TF.flops_per_pixel_from_params(model) == \
        JF.flops_per_pixel_from_params(params)
    assert TF.r2l_analytic_flops_per_pixel(tcfg) == \
        JF.r2l_analytic_flops_per_pixel(jcfg)
    j, _ = _both(["--config", os.path.join(REPO, "configs", "lego.txt")])
    from r2l_tpu.encoding import nerf_embed_dim
    from r2l_tpu.models.nerf import NeRFConfig as JN
    from r2l_tpu.models.nerf import init_nerf as jinit
    from r2l_tpu_torch.models import NeRFConfig as TN
    kw = dict(D=j.netdepth, W=j.netwidth, input_ch=nerf_embed_dim(3, 10),
              input_ch_views=nerf_embed_dim(3, 4), output_ch=5,
              use_viewdirs=True)
    pc = jinit(jax.random.key(0), JN(**kw))
    mc = init_nerf(TN(**kw), torch.Generator().manual_seed(0), "cpu")
    assert TF.count_params(mc) == JF.count_params(pc)
    assert TF.nerf_flops_per_pixel_from_params(mc, 64, 128) == \
        JF.nerf_flops_per_pixel_from_params(pc, 64, 128)


def test_logging_matches_jax(tmp_path):
    """The copied logging runtime: the EMA loss line, the meters, the
    glob resolution and the run directory's layout, as JAX's."""
    import r2l_tpu.logging_ as JL
    from r2l_tpu_torch import logging_ as TL
    lines = [m.LossLine(ema=0.95) for m in (JL, TL)]
    meters = [m.AverageMeter("t") for m in (JL, TL)]
    for v in (0.5, 0.25, 0.4, 0.1):
        for a, b in zip(lines, meters):
            a.update("loss", v)
            b.update(v, n=2)
    assert lines[0].vals == lines[1].vals
    assert lines[0].format() == lines[1].format()
    assert vars(meters[0]) == vars(meters[1])
    (tmp_path / "a_1.msgpack").write_bytes(b"")
    pat = str(tmp_path / "a_*.msgpack")
    assert TL.check_path(pat) == JL.check_path(pat)
    with pytest.raises(FileNotFoundError):
        TL.check_path(str(tmp_path / "none_*"))
    logs = [m.Logger(experiment_name="e", experiments_dir=str(tmp_path / k))
            for m, k in ((JL, "j"), (TL, "t"))]
    for lg in logs:
        lg.print("hello", 3)
        lg.close()
    for lg, k in zip(logs, ("j", "t")):
        rel = os.path.relpath(lg.exp_dir, str(tmp_path / k))
        assert rel.startswith("e-")
        assert sorted(os.listdir(lg.exp_dir)) == ["gen_img", "log",
                                                  "weights"]
        assert open(os.path.join(lg.log_dir, "log.txt")).read().endswith(
            "hello 3\n")
