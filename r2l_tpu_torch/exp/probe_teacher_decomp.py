"""The int8 teacher frame decomposed: coarse pass, ``sample_pdf``, fine pass
and what is left.

Port of ``exp/probe_teacher_decomp.py:84-166``. The canonical teacher
(``_teacher``; coarse and fine from one seeded generator) packed for K7 with
the requantize folded, both networks calibrated on 4,096 random points in
[-4, 4]^3 with random unit directions; one 400x400 frame (focal 555, the
camera 4 units down the y axis looking along it), its 160,000 rays padded
to five chunks of 32,768 (origins 0, directions 1 in the padding). Per
chunk:

* ``full_int8_fold``: the coarse pass (K7, 64 even depths), ``sample_pdf``
  of its weights (deterministic, 128 samples), the sort, the fine pass (K7,
  192 depths), the sum of rgb;
* ``coarse64_only``: the coarse pass, the sum of rgb and weights;
* ``coarse64_plus_pdf``: the coarse pass and ``sample_pdf`` and the sort,
  the sum of rgb and the depths;
* ``fine192_only``: the fine pass on the coarse depths merged with 128 even
  ones (a stand-in for the pdf's).

Each variant renders K = 4 frames, frame i's origins offset by
``linspace(0, 1e-5, K)[i]`` (so no two frames are the same work), one
warm-up call and the fastest of 3 timed with CUDA events. Then
``decomp_summary``, as the JAX driver computes it: ``pdf`` = coarse+pdf -
coarse, ``residual_epilogue`` = full - (coarse+pdf + fine). The JAX
driver's ray tile (4096) is TPU scheduling.

    python -m r2l_tpu_torch.exp.probe_teacher_decomp [--reps R]
        [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from ..kernels.nerf_render import fused_nerf_render, prepare_fused_nerf
from ..render import coarse_z
from ..sampler import PointSampler, even_z_vals
from ..volume import sample_pdf
from . import _harness, _teacher

H = W = _teacher.H
FOCAL = 555.0
CHUNK = 32768
S_C, S_F = _teacher.N_COARSE, _teacher.N_FINE
K = 4           # frames per call
REPS = 3
N_CALIB = 4096
C2W = ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 1.0, -4.0), (0.0, -1.0, 0.0, 0.0))
VARIANTS = ("full_int8_fold", "coarse64_only", "coarse64_plus_pdf",
            "fine192_only")


def setup(device, generator: torch.Generator, ncfg=None, hw: int = H,
          focal: float = FOCAL, chunk: int = CHUNK,
          n_calib: int = N_CALIB):
    """(ncfg, vcfg, (coarse, fine) K7 packings, rays_o, rays_d [n_chunks,
    chunk, 3]): the canonical teacher (or ``ncfg``) and then the
    calibration points and directions, drawn from ``generator`` (on the
    CPU, then moved to ``device``)."""
    ncfg = ncfg or _teacher.nerf_cfg()
    vcfg = _teacher.vol_cfg(S_C, S_F, chunk, _teacher.L_PTS,
                            _teacher.L_VIEWS)
    mc, mf = _teacher.networks(ncfg, generator, device)
    sampler = PointSampler(H=hw, W=hw, focal=focal, n_sample=S_C, near=2.0,
                           far=6.0)
    o, d = sampler.frame_rays(torch.tensor(C2W, dtype=torch.float32,
                                           device=device))
    n_pad = -(-o.shape[0] // chunk) * chunk - o.shape[0]
    ro = torch.cat([o, o.new_zeros((n_pad, 3))]).reshape(-1, chunk, 3)
    rd = torch.cat([d, d.new_ones((n_pad, 3))]).reshape(-1, chunk, 3)
    cal_p = (torch.rand((n_calib, 3), generator=generator) * 8.0 - 4.0)
    cal_d = torch.randn((n_calib, 3), generator=generator)
    cal_d = cal_d / torch.linalg.norm(cal_d, dim=-1, keepdim=True)
    calib = (cal_p.to(device), cal_d.to(device))
    packs = tuple(prepare_fused_nerf(m, ncfg, _teacher.L_PTS,
                                     _teacher.L_VIEWS, calib=calib,
                                     fold_requant=True) for m in (mc, mf))
    return ncfg, vcfg, packs, ro.contiguous(), rd.contiguous()


def _k7(fp, ncfg, vcfg, o, d, z):
    return fused_nerf_render(fp, ncfg, o, d, z.contiguous(),
                             L_pts=vcfg.multires,
                             L_views=vcfg.multires_views,
                             white_bkgd=vcfg.white_bkgd)


def _pdf(vcfg, z, w):
    """The fine depths: ``sample_pdf`` of the coarse weights, merged with
    the coarse depths and sorted."""
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_samp = sample_pdf(z_mid, w[:, 1:-1], vcfg.n_fine, det=True)
    return torch.sort(torch.cat([z, z_samp], -1), -1).values


def chunk_full(packs, ncfg, vcfg, o, d) -> torch.Tensor:
    z = coarse_z(vcfg, o.shape[0], o.device)
    _, _, _, w = _k7(packs[0], ncfg, vcfg, o, d, z)
    rgb, _, _, _ = _k7(packs[1], ncfg, vcfg, o, d, _pdf(vcfg, z, w))
    return rgb.sum()


def chunk_coarse(packs, ncfg, vcfg, o, d) -> torch.Tensor:
    z = coarse_z(vcfg, o.shape[0], o.device)
    rgb, _, _, w = _k7(packs[0], ncfg, vcfg, o, d, z)
    return rgb.sum() + w.sum()


def chunk_coarse_pdf(packs, ncfg, vcfg, o, d) -> torch.Tensor:
    z = coarse_z(vcfg, o.shape[0], o.device)
    rgb, _, _, w = _k7(packs[0], ncfg, vcfg, o, d, z)
    return rgb.sum() + _pdf(vcfg, z, w).sum()


def chunk_fine192(packs, ncfg, vcfg, o, d) -> torch.Tensor:
    zc = coarse_z(vcfg, o.shape[0], o.device)
    zf = even_z_vals(vcfg.near, vcfg.far, vcfg.n_fine, o.device).expand(
        o.shape[0], vcfg.n_fine)
    z = torch.sort(torch.cat([zc, zf], -1), -1).values
    rgb, _, _, _ = _k7(packs[1], ncfg, vcfg, o, d, z)
    return rgb.sum()


CHUNK_FNS = {"full_int8_fold": chunk_full, "coarse64_only": chunk_coarse,
             "coarse64_plus_pdf": chunk_coarse_pdf,
             "fine192_only": chunk_fine192}


def frames(name: str, packs, ncfg, vcfg, ro, rd, k: int = K
           ) -> torch.Tensor:
    """k frames of the variant, frame i's origins offset by
    ``linspace(0, 1e-5, k)[i]``: the sum of the frames' sums of their
    chunks' values."""
    fn = CHUNK_FNS[name]
    offs = even_z_vals(0.0, 1e-5, k, ro.device)  # jnp.linspace's, exactly
    return torch.stack([
        torch.stack([fn(packs, ncfg, vcfg, o + off, d)
                     for o, d in zip(ro, rd)]).sum()
        for off in offs]).sum()


def summary(ms: dict) -> dict:
    """The JAX driver's decomposition of the variants' ms per frame."""
    return {"name": "decomp_summary", "full": ms["full_int8_fold"],
            "coarse": ms["coarse64_only"],
            "pdf": ms["coarse64_plus_pdf"] - ms["coarse64_only"],
            "fine": ms["fine192_only"],
            "residual_epilogue": ms["full_int8_fold"]
            - (ms["coarse64_plus_pdf"] + ms["fine192_only"])}


def main(argv=None) -> list[dict]:
    args = _harness.parse(
        argv, "python -m r2l_tpu_torch.exp.probe_teacher_decomp", __doc__,
        reps=REPS)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log(_harness.device_record())]
    ncfg, vcfg, packs, ro, rd = setup(
        dev, torch.Generator().manual_seed(_teacher.SEED))
    n_rays = H * W
    p_ops = _teacher.point_ops(ncfg) * n_rays
    ops = {"full_int8_fold": p_ops * (S_C + S_C + S_F),
           "coarse64_only": p_ops * S_C, "coarse64_plus_pdf": p_ops * S_C,
           "fine192_only": p_ops * (S_C + S_F)}
    ms = {}
    for name in VARIANTS:
        rec = _harness.timed(
            name, lambda n=name: frames(n, packs, ncfg, vcfg, ro, rd),
            args.reps, K, log, ops=ops[name])
        ms[name] = rec["ms_per_frame"]
        recs.append(rec)
    recs.append(log(summary(ms)))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
