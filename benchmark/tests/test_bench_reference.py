"""The plain reference agrees with the program's plain versions on the same
weights at small sizes on the CPU: the student's frame and the teacher's
volumetric render, float32."""
import numpy as np
import torch

from harness import poses, weights
from harness.drivers import datagen, view
from reference import nerf as rnerf
from reference import r2l as rr2l

R2L_SMALL = {"netdepth": 10, "netwidth": 64, "num_blocks": 4,
             "n_learnable": 2, "use_residual": True, "n_sample": 16,
             "embed_L": 10, "input_dim": 1008, "output_dim": 3, "H": 24,
             "W": 20, "focal": 30.0, "near": 2.0, "far": 6.0}


def test_the_student_frame_agrees_with_the_program():
    from r2l_tpu_torch.sampler import PointSampler
    w = weights.r2l_weights(R2L_SMALL, torch.Generator().manual_seed(3))
    model, cfg = view.load_student(R2L_SMALL, {}, w, torch.device("cpu"))
    c = R2L_SMALL
    sampler = PointSampler(H=c["H"], W=c["W"], focal=c["focal"],
                           n_sample=16, near=2.0, far=6.0)
    pose = torch.as_tensor(poses.pose_spherical(40.0, -30.0, 4.0)[:3, :4])
    from r2l_tpu_torch.encoding import r2l_embed
    with torch.no_grad():
        pts = sampler.sample_test(pose)
        assert torch.equal(pts, rr2l.frame_points(pose, c["H"], c["W"],
                                                  c["focal"], 16, 2.0, 6.0))
        want = model(r2l_embed(pts, 10)).reshape(c["H"], c["W"], 3)
        got = rr2l.frame(w, c, pose, block=100)
    assert float((got - want).abs().max()) < 1e-5


NERF_SMALL = {"D": 8, "W": 32, "skips": [4], "use_viewdirs": True,
              "multires": 10, "multires_views": 4, "input_ch": 63,
              "input_ch_views": 27, "output_ch": 4, "N_samples": 16,
              "N_importance": 16, "perturb": True, "raw_noise_std": 0.0,
              "white_bkgd": True, "near": 2.0, "far": 6.0, "chunk": 64,
              "density_floor": 1.0}


def test_the_teacher_render_agrees_with_the_program():
    from r2l_tpu_torch.models import NeRF
    from r2l_tpu_torch.render import ChunkDraws, render_rays_nerf
    g = torch.Generator().manual_seed(5)
    wc, wf = (weights.nerf_weights(NERF_SMALL, g) for _ in range(2))
    ncfg, vcfg = datagen._ncfg(NERF_SMALL, {}), datagen._vcfg(NERF_SMALL)
    models = []
    for w in (wc, wf):
        m = NeRF(ncfg, torch.device("cpu"))
        m.load_state_dict(w)
        models.append(m)
    rng = np.random.default_rng(0)
    c2w, focal = poses.rand_pose_and_focal(rng, 10.0, True)
    o, d = (torch.as_tensor(a[:64]) for a in rnerf.rays(c2w, 8, 8, focal))
    u_s, u_p = datagen.draws(NERF_SMALL, 9, 64, torch.device("cpu"))
    with torch.no_grad():
        want = render_rays_nerf(models[0], models[1], ncfg, vcfg, o, d,
                                ChunkDraws(u_strat=u_s[0], u_pdf=u_p[0]))
        got = rnerf.render(wc, wf, NERF_SMALL, o, d, u_s[0], u_p[0])
    assert float((got - want.rgb_map).abs().max()) < 1e-5
