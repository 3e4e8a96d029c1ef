"""Does int8 engage on a trained teacher? Its bf16 and int8 fused frames
side by side, and the plain frame.

Port of ``exp/dbg_int8_engage.py``, which reads a checkpoint at a fixed
path; here ``--ckpt PATH`` names the teacher ``.msgpack`` (``{"coarse",
"fine"}``, as the trainer saves it), loaded by ``checkpoint.load_teacher``
into networks whose shape is read from the file (depth, width, the
encodings' bands, view directions, a fine network or not), computing in
bf16. It renders one 64x64 frame at focal 64 from ``pose_spherical(30,
-30, 4)`` with 16 coarse (and 16 fine) samples, chunks of 4,096 rays:
``render_frame_nerf_fused`` with bf16 weights (K6), then in int8 (K7)
calibrated on every 16th ray at 9 depths in [2, 6] with the normalised view
directions, then the plain ``render_frame_nerf``, and prints the JAX
script's lines: the shapes, the bf16 frame's range, the int8 frame's
distance from it (max, mean, identical), the plain frame's range and its
largest ``acc``. The numbers also go out as one JSON record.

    python -m r2l_tpu_torch.exp.dbg_int8_engage --ckpt PATH [--out PATH]

(on a GPU.)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint import load_checkpoint, load_teacher
from ..models.nerf import NeRFConfig, init_nerf
from ..rays import get_rays, pose_spherical
from ..render import (VolRenderConfig, render_frame_nerf,
                      render_frame_nerf_fused)
from . import _harness
from ._teacher import calibration

HW, FOCAL = 64, 64.0
N_SAMPLES = 16
CHUNK = 4096
CALIB_EVERY = 16
POSE = (30.0, -30.0, 4.0)


def _first(layers):
    """Layer 0 of a saved list (the codec writes lists as {"0": ...})."""
    return layers["0"] if isinstance(layers, dict) else layers[0]


def teacher_shape(raw: dict) -> dict:
    """D, W, the input widths, L, Lv, viewdirs and a fine network, read
    from a saved teacher tree as the JAX script reads them."""
    pc = raw["coarse"]
    w0 = np.asarray(_first(pc["pts_linears"])["w"])
    in_ch, W = w0.shape
    use_vd = bool(pc.get("views_linears"))
    in_v = (np.asarray(_first(pc["views_linears"])["w"]).shape[0] - W
            if use_vd else 0)
    return {"D": len(pc["pts_linears"]), "W": W, "in_ch": in_ch,
            "in_v": in_v, "L": (in_ch // 3 - 1) // 2,
            "Lv": (in_v // 3 - 1) // 2 if use_vd else 0,
            "use_vd": use_vd, "fine": bool(raw.get("fine"))}


def configs(s: dict) -> tuple[NeRFConfig, VolRenderConfig]:
    """The JAX script's network and render configs for shape ``s``."""
    D = s["D"]
    ncfg = NeRFConfig(D=D, W=s["W"], skips=(4,) if D > 4 else (D // 2,),
                      use_viewdirs=s["use_vd"], input_ch=s["in_ch"],
                      input_ch_views=s["in_v"],
                      output_ch=5 if s["fine"] else 4,
                      compute_dtype=torch.bfloat16)
    vcfg = VolRenderConfig(n_coarse=N_SAMPLES,
                           n_fine=N_SAMPLES if s["fine"] else 0,
                           perturb=False, use_viewdirs=s["use_vd"],
                           multires=s["L"], multires_views=s["Lv"],
                           near=2.0, far=6.0, white_bkgd=True,
                           ray_chunk=CHUNK)
    return ncfg, vcfg


def load(path: str, device) -> tuple:
    """(shape, ncfg, vcfg, coarse, fine or None) of the checkpoint."""
    raw, _ = load_checkpoint(path)
    s = teacher_shape(raw)
    ncfg, vcfg = configs(s)
    gen = torch.Generator().manual_seed(0)   # overwritten by the load
    mc = init_nerf(ncfg, gen, device)
    mf = init_nerf(ncfg, gen, device) if s["fine"] else None
    load_teacher(path, mc, mf)
    return s, ncfg, vcfg, mc, mf


def engage(ncfg, vcfg, mc, mf, device, hw: int = HW,
           focal: float = FOCAL) -> dict:
    """The three frames of the script and their numbers."""
    ro, rd = get_rays(hw, hw, focal, pose_spherical(*POSE)[:3, :4],
                      device=device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    rgb_bf = render_frame_nerf_fused(mc, mf, ncfg, vcfg, ro, rd)["rgb"]
    pts, vds = calibration(ro[None], rd[None], CALIB_EVERY)
    rgb_i8 = render_frame_nerf_fused(
        mc, mf, ncfg, vcfg, ro, rd,
        int8_calib=(pts, vds if ncfg.use_viewdirs else None))["rgb"]
    plain = render_frame_nerf(mc, mf, ncfg, vcfg, ro, rd)
    d = (rgb_bf - rgb_i8).abs()
    return {"bf16_min": float(rgb_bf.min()), "bf16_max": float(rgb_bf.max()),
            "int8_vs_bf16_max": float(d.max()),
            "int8_vs_bf16_mean": float(d.mean()),
            "identical": bool(torch.equal(rgb_bf, rgb_i8)),
            "plain_min": float(plain["rgb"].min()),
            "plain_max": float(plain["rgb"].max()),
            "plain_acc_max": float(plain["acc"].max())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m r2l_tpu_torch.exp.dbg_int8_engage",
        description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True,
                   help="a teacher .msgpack ({coarse, fine})")
    p.add_argument("--out", help="also append the JSON record to this file")
    args = p.parse_args(argv)
    dev = _harness.require_cuda(p.prog)
    s, ncfg, vcfg, mc, mf = load(args.ckpt, dev)
    print("D,W,in_ch,in_v,L,Lv,use_vd,fine", s["D"], s["W"], s["in_ch"],
          s["in_v"], s["L"], s["Lv"], s["use_vd"], s["fine"], flush=True)
    r = engage(ncfg, vcfg, mc, mf, dev)
    print("rgb range bf16", r["bf16_min"], r["bf16_max"])
    print("int8-vs-bf16: max", r["int8_vs_bf16_max"], "mean",
          r["int8_vs_bf16_mean"])
    print("identical:", r["identical"])
    print("XLA rgb range", r["plain_min"], r["plain_max"], "acc max",
          r["plain_acc_max"], flush=True)
    return _harness.Log(args.out)({"name": "dbg_int8_engage",
                                   "ckpt": args.ckpt, **s, **r})


if __name__ == "__main__":
    main()
