"""The port never imports JAX nor the JAX package: a fresh interpreter imports
r2l_tpu_torch and every module in it, renders a frame on the CPU through
each kind and through the kernel API, takes a distillation step of each
kind, saves the state through the port's own msgpack codec and resumes it,
exports the student to ONNX, takes a step in the images data mode, renders
a teacher frame, generates one pose of pseudo data (plain and int8-packed
fused render on the CPU; the int8 pass also with pe_ladder=False and
bf16_requant), takes a teacher step of each mode on images and
their ray records, runs each exp probe's plain version (the chain and shape
probes, and K2's body, wall, streams and epilogue probes, and the int8-dL/dx
walk), runs the bodies of the exp drivers that reach no kernel of their
own (the int8 frame, its batched call against the frames, K2's epilogue
forms and bf16 residual, the teacher frame's decomposition, a
hard-sampling draw, the training pieces, dbg_int8_engage on a saved
teacher), renders an int8
given-rays frame and its bench checksum, computes
SSIM, FLIP and LPIPS, imports ``bench_cuda.py``'s function, parses the
command line and maps it to a student config, runs each datagen mode other
than ``rand``, decodes a PNG and area-resizes it, decodes a JPEG fixture
to its recorded digest, runs a data-parallel step and a sharded frame on a
one-rank gloo group (``r2l_tpu_torch.parallel``), counts FLOPs, imports
``main_cuda.py`` and the create-data tool, and finds none of ``jax``,
``r2l_tpu``, ``flax`` and ``msgpack`` in sys.modules. The kernel
sources include only the CUDA toolkit's headers and their own."""
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
model = init_r2l(cfg, torch.Generator().manual_seed(0), "cpu")
sampler = PointSampler(H=4, W=4, focal=5.0, n_sample=2, near=2.0, far=6.0)
poses = np.stack([pose_spherical(t, -30.0, 4.0)[:3, :4] for t in (0, 90)])
for kw in ({"use_pallas": False}, {}, {"quantize": "int8"}):
    assert make_r2l_frame_fn(model, cfg, sampler, calib_poses=poses,
                             **kw)(poses[0]).shape == (4, 4, 3)
from r2l_tpu_torch.encoding import r2l_embed
from r2l_tpu_torch.kernels import fused_r2l_apply, prepare_fused_params
x = r2l_embed(sampler.sample_test(torch.from_numpy(poses[0])), 10)
assert fused_r2l_apply(prepare_fused_params(model, cfg), cfg,
                       x).shape == (16, 3)
from r2l_tpu_torch.train import (DistillConfig, fused_int8_calib_points,
                                 init_train_state, make_distill_step)
dcfg = DistillConfig(batch_size=32, n_hard_in=4, n_hard_out=8, hard_mul=2.0)
calib = fused_int8_calib_points(32, 32, 40.0, 2, 2.0, 6.0, poses, "cpu")
fresh = np.random.default_rng(0).uniform(size=(24, 9)).astype(np.float32)
for kw in ({}, {"fused_vjp": True},
           {"fused_vjp": True, "fused_quantize": "int8",
            "fused_calib_pts": calib},
           {"fused_vjp": True, "fused_quantize": "int8",
            "fused_calib_pts": calib, "fused_stash_q": False}):
    state = init_train_state(model, dcfg, device="cpu")
    step = make_distill_step(cfg, dcfg, sampler, device="cpu", **kw)
    state, m = step(state, fresh)
    assert state.step == 1 and bool(torch.isfinite(m["loss"]))
import tempfile
from r2l_tpu_torch import checkpoint as ckpt
from r2l_tpu_torch.export import export_onnx
with tempfile.TemporaryDirectory() as tmp:
    ckpt.save(tmp + "/s.msgpack", state, state.step, -1.0, -1,
              save_pool=True)
    back = init_train_state(init_r2l(cfg, torch.Generator().manual_seed(5),
                                     "cpu"), dcfg, device="cpu")
    back, _, _ = ckpt.resume_distill(back, tmp + "/s.msgpack",
                                     log=lambda s: None)
    assert back.step == back.lr_count == 1
    assert all(torch.equal(a, b) for a, b in zip(
        back.params.state_dict().values(), model.state_dict().values()))
    assert torch.equal(back.pool.rays, state.pool.rays)
    assert export_onnx(model, cfg, tmp, log=lambda s: None).endswith(
        "r2l.onnx")
from r2l_tpu_torch.train import make_distill_step_images
img = torch.rand((4, 4, 3), generator=torch.Generator().manual_seed(1))
step = make_distill_step_images(cfg, DistillConfig(batch_size=8), sampler,
                                4, 4, 5.0, precrop_iters=1, device="cpu")
state = init_train_state(model, DistillConfig(batch_size=8), device="cpu")
state, m = step(state, img, torch.from_numpy(poses[0]))
assert state.step == 1 and bool(torch.isfinite(m["loss"]))
import tempfile
from r2l_tpu_torch.datagen import DataGenConfig, generate_pseudo_data
from r2l_tpu_torch.evaluate import make_nerf_frame_fn
from r2l_tpu_torch.models import NeRFConfig, init_nerf
from r2l_tpu_torch.render import VolRenderConfig, render_frame_nerf_fused
ncfg = NeRFConfig(D=3, W=32, skips=(1,), input_ch=27, input_ch_views=15)
gen = torch.Generator().manual_seed(0)
mc, mf = init_nerf(ncfg, gen, "cpu"), init_nerf(ncfg, gen, "cpu")
vcfg = VolRenderConfig(n_coarse=4, n_fine=4, multires=4, multires_views=2,
                       white_bkgd=True)
frame = make_nerf_frame_fn(mc, mf, ncfg, vcfg, sampler, use_pallas=True,
                           perturb_test=True, device="cpu")
assert frame.kind == "plain" and frame(poses[0]).shape == (4, 4, 3)
ro, rd = torch.zeros(6, 3), torch.randn(6, 3, generator=gen)
calib = (torch.randn(40, 3, generator=gen), torch.randn(40, 3, generator=gen))
out = render_frame_nerf_fused(mc, mf, ncfg, vcfg, ro, rd, int8_calib=calib,
                              fold_requant=True)
assert out["rgb"].shape == (6, 3)
from r2l_tpu_torch.kernels.nerf_render import (fused_nerf_render,
                                               prepare_fused_nerf)
fpn = prepare_fused_nerf(mc, ncfg, 4, 2, calib=calib)
zn = torch.linspace(2.0, 6.0, 5).expand(6, 5).contiguous()
assert fused_nerf_render(fpn, ncfg, ro, rd, zn, 4, 2, pe_ladder=False,
                         bf16_requant=True)[0].shape == (6, 3)
with tempfile.TemporaryDirectory() as tmp:
    gcfg = DataGenConfig(n_pose=1, H=4, W=4, focal=5.0, save_every=1)
    assert generate_pseudo_data(mc, mf, ncfg, vcfg, gcfg, tmp,
                                device="cpu") == 16
from r2l_tpu_torch.datagen import images_to_ray_records
from r2l_tpu_torch.train import (TeacherTrainConfig, init_teacher_state,
                                 make_teacher_step, make_teacher_step_batched)
imgs = np.random.default_rng(2).uniform(size=(2, 4, 4, 3)).astype(np.float32)
tcfg = TeacherTrainConfig(n_rand=8, precrop_iters=1)
st = init_teacher_state(mc, mf, tcfg)
st, m = make_teacher_step(ncfg, vcfg, tcfg, 4, 4, 5.0, device="cpu")(
    st, imgs, poses)
pool = images_to_ray_records(imgs, poses, 4, 4, 5.0, device="cpu")
assert pool.shape == (32, 9)
st, m = make_teacher_step_batched(ncfg, vcfg, tcfg, device="cpu")(
    st, pool, 8)
assert st.step == 2 and bool(torch.isfinite(m["loss"]))
from r2l_tpu_torch.exp import probe_mxu as PM, probe_shapes as PS
x = torch.randn((8, 256), generator=torch.Generator().manual_seed(3))
for name in PM.VARIANTS:
    w = PM.variant_weights(name, torch.Generator().manual_seed(4), "cpu",
                           n_layers=2)
    assert bool(torch.isfinite(PM.make_variant(name, w)(x)))
for dt in (torch.int8, torch.bfloat16):
    xs, ws = PS.shape_inputs(4, 256, 256, dt, torch.Generator().manual_seed(5),
                             n_tiles=2, n_layers=2, device="cpu")
    for chained in (False, True):
        assert PS.unchained(xs, ws, chained).shape == (8, 1)
from r2l_tpu_torch.exp import (probe_epi as PE, probe_int8 as PI,
                               probe_pipe as PP, probe_pipe_lib as PL,
                               probe_wall as PW)
assert PP.apply_int8_pe_streams is PL.apply_int8_pe_streams
for name in PI.VARIANTS:
    assert bool(torch.isfinite(PI.make_variant(
        name, PI.variant_weights(name, "cpu", n_blocks=1))(x)))
w, m = PW.make_weights(torch.Generator().manual_seed(6), 2, "cpu")
for mode in PW.MODES:
    assert PW.wall(x, w, m, mode).shape == (8, 256)
from r2l_tpu_torch.kernels.r2l_fused import calibrate_r2l_int8_pe
cfg8 = R2LConfig(input_dim=6 * 21, netdepth=4, netwidth=256)
model8 = init_r2l(cfg8, torch.Generator().manual_seed(7), "cpu")
pts = sampler.sample_test(torch.from_numpy(poses[0]))
fp8 = calibrate_r2l_int8_pe(model8, cfg8, 6, 10, pts)
for s in PL.STREAMS:
    assert PL.apply_int8_pe_streams(fp8, cfg8, pts, 6, 10,
                                    streams=s).shape == (16, 3)
for v in PE.VARIANTS:
    assert PE.apply_variant(fp8, cfg8, pts, 6, 10, v).shape == (16, 3)
from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
from r2l_tpu_torch.kernels.r2l_train import train_fwd_int8
cfgq = R2LConfig(input_dim=6 * 21, netdepth=6, netwidth=32,
                 compute_dtype=torch.bfloat16)
modelq = init_r2l(cfgq, torch.Generator().manual_seed(8), "cpu")
ptsq = torch.rand((64, 6), generator=torch.Generator().manual_seed(9))
fpq = calibrate_r2l_int8_pe(modelq, cfgq, 6, 10, ptsq, fold_requant=False)
_, stq = train_fwd_int8(fpq, cfgq, ptsq, 6, 10, stash_q=True)
bwq = torch.stack([m.weight.detach() for m in modelq.linears()[1]]).bfloat16()
dhq = torch.randn((64, 32), generator=torch.Generator().manual_seed(10))
for v in PQ.VARIANTS:
    dh, dws = PQ.walk(v, cfgq, bwq, fpq, stq, dhq, gb=2, tile=32)
    assert dh.shape == (64, 32) and len(dws) == 1
from r2l_tpu_torch.evaluate import (make_r2l_givenrays_bench_fn,
                                    make_r2l_givenrays_frame_fn)
ro, rd = sampler.frame_rays(torch.from_numpy(poses[0]))
given = make_r2l_givenrays_frame_fn(model, cfg, sampler, 4, 4,
                                    quantize="int8", calib_rays=(ro, rd))
assert given.kind == "int8" and given(ro, rd).shape == (4, 4, 3)
bench = make_r2l_givenrays_bench_fn(model, cfg, sampler, 4, 4,
                                    parts=given.parts)
assert bool(torch.isfinite(bench(ro[None], rd[None])))
from r2l_tpu_torch.flip import flip
from r2l_tpu_torch.lpips import init_lpips, lpips
from r2l_tpu_torch.metrics import ssim
a = torch.rand((33, 35, 3), generator=torch.Generator().manual_seed(11))
b = torch.rand((33, 35, 3), generator=torch.Generator().manual_seed(12))
lp = init_lpips(torch.Generator().manual_seed(13), "alex", device="cpu")
for v in (ssim(a, b), flip(a, b), lpips(lp, a, b)):
    assert bool(torch.isfinite(v))
from bench_cuda import bench as bench_cuda_fn
assert callable(bench_cuda_fn)
import main_cuda
from r2l_tpu_torch.configs import args_to_r2l_config, parse_args
from r2l_tpu_torch.tools import create_data
assert callable(main_cuda.train) and callable(create_data.main)
a = parse_args(["--config", "configs/lego.txt", "--netwidth", "64",
                "--trial.ON", "--trial.body_arch", "resmlp"])
assert args_to_r2l_config(a).netwidth == 64
from r2l_tpu_torch import datagen as DG
from r2l_tpu_torch.flops import count_params, flops_per_pixel_from_params
with tempfile.TemporaryDirectory() as tmp:
    g = DG.DataGenConfig(n_pose=1, H=16, W=16, focal=20.0, save_every=1)
    for fn in (DG.generate_tworays, DG.generate_3x3rays,
               DG.generate_rand_images, DG.generate_patches,
               DG.generate_pseudo_images):
        kw = {"n_pose": 1} if fn is DG.generate_pseudo_images else {}
        assert fn(mc, mf, ncfg, vcfg, g, tmp, device="cpu", **kw) >= 1
    from r2l_tpu_torch.data.imageio_ import read_image, resize_area
    from r2l_tpu_torch.evaluate import write_png
    img = (np.random.default_rng(3).uniform(size=(8, 6, 3)) * 255
           ).astype(np.uint8)
    write_png(tmp + "/i.png", img)
    assert (read_image(tmp + "/i.png") == img).all()
    assert resize_area(img, 3, 4).shape == (4, 3, 3)
    import hashlib, json
    from r2l_tpu_torch.data.imageio_ import read_jpeg
    with open("tests/fixtures/jpeg/digests.json") as f:
        dig = json.load(f)["s420.jpg"]
    a = read_jpeg("tests/fixtures/jpeg/s420.jpg")
    assert hashlib.sha256(a.tobytes()).hexdigest() == dig["sha256"]
    import torch.distributed as dist
    from r2l_tpu_torch.parallel import gather_rows, make_mesh, shard_rows
    dist.init_process_group("gloo", init_method="file://" + tmp + "/rdv",
                            rank=0, world_size=1)
    mesh = make_mesh({"data": 1, "model": 1})
    x = torch.arange(10.0).reshape(5, 2)
    assert torch.equal(gather_rows(shard_rows(x, mesh), mesh, 5), x)
    state = init_train_state(model, dcfg, device="cpu")
    state, m = make_distill_step(cfg, dcfg, sampler, device="cpu",
                                 mesh=mesh)(state, fresh)
    assert bool(torch.isfinite(m["loss"]))
    assert make_r2l_frame_fn(model, cfg, sampler, mesh=mesh)(
        poses[0]).shape == (4, 4, 3)
    dist.destroy_process_group()
assert count_params(model) > 0 and flops_per_pixel_from_params(model) > 0
from r2l_tpu_torch.exp import (_teacher as XT, dbg_int8_engage as XG,
                               probe_batch as XB, probe_decomp as XD,
                               probe_epi2 as XE, probe_mine as XM,
                               probe_teacher_decomp as XTD,
                               probe_train_decomp as XTR, _train as XR)
cfgx = R2LConfig(netdepth=4, netwidth=64, compute_dtype=torch.bfloat16)
cx, fpx, dpx, smx, psx = XD.setup("cpu", torch.Generator().manual_seed(0), 2,
                                  cfgx, hw=4, focal=5.0)
assert bool(torch.isfinite(XD.full(fpx, cx, dpx, smx, psx)))
assert XB.compare(fpx, cx, dpx, smx, psx)["max_abs_err_vs_frames"] < 2.5e-2
cx, fps, smx, psx = XE.setup("cpu", torch.Generator().manual_seed(1), 2,
                             cfgx, hw=4, focal=5.0, calib_hw=4)
for _, fold, nb, br in XE.FORMS:
    assert XE.form(fps, cx, smx.sample_test(psx[0]), fold, nb,
                   br).shape == (16, 3)
ncx = XT.nerf_cfg(D=3, W=32, skips=(1,))
ncx, vcx, packs, rox, rdx = XTD.setup("cpu", torch.Generator().manual_seed(2),
                                      ncx, hw=4, focal=5.0, chunk=8,
                                      n_calib=32)
vcx = XT.vol_cfg(8, 8, 8)
for name in XTD.VARIANTS:
    assert bool(torch.isfinite(XTD.frames(name, packs, ncx, vcx, rox, rdx, 2)))
gx = torch.Generator().manual_seed(3)
idx = XM.draw("sample_strat", gx, 64, 8)
assert float(XM.pick(torch.ones(64, 9), torch.zeros(1), idx)) == 8.0
dcx = XR.distill_config(64, 4, 8)
smr = XR.sampler(4, 5.0)
calx = XR.calib_points("cpu", 4, 5.0)
_, mx = XR.student(torch.Generator().manual_seed(4), "cpu", cfgx)
fns = XTR.pieces(mx, cfgx, dcx, smr, calx, torch.rand(64, 48),
                 torch.rand(64, 9), torch.rand(64, 16))
for name in XTR.PIECES:
    assert bool(torch.isfinite(fns[name]()))
with tempfile.TemporaryDirectory() as tmp:
    ckpt.save(tmp + "/t.msgpack", init_teacher_state(mc, mf, tcfg), 0, -1.0,
              -1)
    shape, ncg, vcg, gc, gf = XG.load(tmp + "/t.msgpack", "cpu")
    assert (shape["D"], shape["L"], shape["Lv"]) == (3, 4, 2)
    assert XG.engage(ncg, vcg, gc, gf, "cpu", hw=4, focal=5.0)["bf16_max"] > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "r2l_tpu", "flax", "msgpack"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 28 and bad.strip() == "[]"


def test_port_sources_name_no_jax_import():
    """No ``import jax`` / ``from jax`` line, nor an import of the JAX
    package or of its ``exp/`` drivers, anywhere in the port (its own
    ``exp`` drivers import each other relatively), chip_smoke.py,
    bench_cuda.py or main_cuda.py."""
    pkg = os.path.join(REPO, "r2l_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bench_cuda.py"),
             os.path.join(REPO, "main_cuda.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            for ln in fh:
                s = ln.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import r2l_tpu ", "import r2l_tpu.",
                                         "from r2l_tpu ", "from r2l_tpu.",
                                         "import exp", "from exp ",
                                         "from exp.")), (path, s)


def test_kernel_sources_include_only_cuda_and_their_own_headers():
    """Every ``#include`` of ``r2l_tpu_torch/kernels/csrc`` names a system
    header (``<...>``) or a header beside it: nothing of the JAX package,
    ``exp/`` or PyTorch."""
    csrc = os.path.join(REPO, "r2l_tpu_torch", "kernels", "csrc")
    own = set(os.listdir(csrc))
    n_includes = 0
    for name in sorted(own):
        with open(os.path.join(csrc, name)) as fh:
            for ln in fh:
                if not ln.startswith("#include"):
                    continue
                n_includes += 1
                target = ln.split(None, 1)[1].strip()
                if target.startswith("<"):
                    assert not target.startswith(("<torch", "<ATen", "<c10")),\
                        (name, target)
                else:
                    assert target.strip('"') in own, (name, target)
    assert n_includes >= len(own)
