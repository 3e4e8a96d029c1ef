"""One-command released-checkpoint parity harness, run with the port.

Counterpart of ``tools/verify_released_ckpt.py``, with the same flags and
output. The command to run once a released reference checkpoint
(`scripts/download_R2L_models.sh` in the reference, e.g.
``R2L_Blender_Models/lego.tar``) is on the machine:

  python -m r2l_tpu_torch.tools.verify_released_ckpt --ckpt lego.tar \\
      --datadir data/nerf_synthetic/lego --half_res \\
      --expect_psnr 31.87 --tol 0.05

It loads the torch ``.tar`` (reference save_ckpt schema,
`main.py:1516-1542` in the reference) or a native ``.msgpack``, renders the
blender test split through every inference path — ``xla`` (the plain
``R2L`` module at the checkpoint's f32), ``pallas`` (K1, bf16 weights) and
``int8`` (K2) — and prints the PSNR/PSNRv2/SSIM/FLIP (+LPIPS with
``--lpips_weights``) table per path, with the reference's min-max input
conventions by default (``--lpips_rescale/--flip_rescale minmax``,
`main.py:361-377`), then a PASS/FAIL verdict against ``--expect_psnr`` at
``--tol`` dB (int8 at max(tol, 0.5)) and a JSON line. Exit code 1 on FAIL.
``--platform auto`` runs on the CUDA card (all three paths by default) and
raises without one; ``--platform cpu`` runs on the host (``xla`` by
default: the kernels' plain versions are slow there).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..app import apply_platform
from ..checkpoint import (infer_r2l_config_from_params,
                          infer_r2l_config_from_state_dict, load_checkpoint,
                          load_torch_tar, torch_r2l_to_params)
from ..data.blender import load_blender_data
from ..evaluate import make_r2l_frame_fn, render_path
from ..kernels.r2l_fused import fused_kernel_supported
from ..models._layout import restore_lists
from ..models.r2l import R2L, params_from_jax
from ..sampler import PointSampler


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="released torch .tar checkpoint (reference "
                        "save_ckpt schema) or a native .msgpack")
    p.add_argument("--datadir", required=True,
                   help="blender scene dir (transforms_test.json)")
    p.add_argument("--half_res", action="store_true", default=False,
                   help="render at 400x400 (the released R2L models were "
                        "trained half-res, reference configs/*.txt)")
    p.add_argument("--testskip", type=int, default=1)
    p.add_argument("--white_bkgd", action="store_true", default=True)
    p.add_argument("--no_white_bkgd", dest="white_bkgd",
                   action="store_false")
    p.add_argument("--multires", type=int, default=10,
                   help="R2L input PE frequency count L (reference "
                        "--multires)")
    # what checkpoint shapes cannot express, as app.build_r2l takes it
    # from the flags; defaults match the released R2L models
    p.add_argument("--use_residual", action="store_true", default=True,
                   help="global body(x)+x residual (released models: on)")
    p.add_argument("--no_residual", dest="use_residual",
                   action="store_false")
    p.add_argument("--linear_tail", action="store_true", default=False,
                   help="tail without sigmoid (native ckpts only; torch "
                        "tars carry it in the key naming)")
    p.add_argument("--act", type=str, default="relu",
                   choices=["relu", "lrelu", "none"],
                   help="head/in-block activation (non-relu renders the "
                        "plain module only)")
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--expect_psnr", type=float, default=None,
                   help="expected test PSNR (dB); e.g. the reference "
                        "blender table: 31.87 pseudo+real, 30.48 "
                        "pseudo-only. Omit for report-only mode")
    p.add_argument("--tol", type=float, default=0.05,
                   help="PSNR tolerance in dB (north star: 0.05)")
    p.add_argument("--flip_rescale", type=str, default="minmax",
                   choices=["standard", "minmax"],
                   help="FLIP input convention; 'minmax' (default here) "
                        "reproduces the reference's rescaled-input FLIP "
                        "(main.py:361-377)")
    p.add_argument("--lpips_weights", type=str, default="",
                   help="torch LPIPS state_dict (.pt) — omit to skip LPIPS")
    p.add_argument("--lpips_net", type=str, default="alex",
                   choices=["alex", "vgg", "squeeze"])
    p.add_argument("--lpips_rescale", type=str, default="minmax",
                   choices=["standard", "minmax"],
                   help="'minmax' (default here) = the reference's "
                        "min-max [-1,1] rescale (main.py:361-364)")
    p.add_argument("--paths", type=str, default="auto",
                   help="comma list of inference paths to verify: xla, "
                        "pallas, int8. 'auto' = all on the card, xla on "
                        "the host")
    p.add_argument("--max_frames", type=int, default=0,
                   help="cap the test-split frame count (0 = all)")
    p.add_argument("--platform", type=str, default="auto",
                   choices=["auto", "cpu", "tpu"])
    p.add_argument("--num_cpu_devices", type=int, default=0)
    return p


def load_student(args, device: torch.device):
    """(cfg, model) of ``--ckpt``: a ``.tar``'s state_dict or a native
    tree, the architecture from its shapes and the flags."""
    arch = dict(use_residual=args.use_residual, act=args.act, inact=args.act)
    if args.ckpt.endswith(".tar"):
        blob = load_torch_tar(args.ckpt)
        sd = blob.get("network_fn_state_dict", blob)
        cfg = infer_r2l_config_from_state_dict(sd, **arch)
        params = torch_r2l_to_params(sd, cfg)
        print(f"converted torch ckpt {args.ckpt}: "
              f"input_dim {cfg.input_dim}, W {cfg.netwidth}, "
              f"{cfg.num_blocks} blocks "
              f"(global_step {blob.get('global_step', '?')}, "
              f"best_psnr {blob.get('best_psnr', '?')})")
    else:
        raw, meta = load_checkpoint(args.ckpt)
        p0 = raw["params"] if isinstance(raw, dict) and "params" in raw \
            else raw
        params = restore_lists(p0)
        cfg = infer_r2l_config_from_params(
            params, linear_tail=args.linear_tail, **arch)
        print(f"loaded native ckpt {args.ckpt} "
              f"(global_step {meta.get('global_step', '?')})")
    model = R2L(cfg, device)
    with torch.no_grad():
        model.load_state_dict(params_from_jax(params, cfg))
    return cfg, model


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = apply_platform(args)
    cfg, model = load_student(args, device)
    n_sample = cfg.input_dim // (3 * (2 * args.multires + 1))
    if n_sample * 3 * (2 * args.multires + 1) != cfg.input_dim:
        raise SystemExit(f"input_dim {cfg.input_dim} is not "
                         f"n_sample*3*(2L+1) for L={args.multires} — pass "
                         "the right --multires")

    data = load_blender_data(args.datadir, half_res=args.half_res,
                             testskip=args.testskip)
    images = (data.white_bkgd_rgb() if args.white_bkgd
              else data.black_bkgd_rgb())
    i_test = data.i_split[2]
    if args.max_frames > 0:
        i_test = i_test[:args.max_frames]
    poses = data.poses[i_test][:, :3, :4]
    gt = images[i_test]
    print(f"test split: {len(i_test)} frames at "
          f"{data.H}x{data.W} (half_res={args.half_res})")
    sampler = PointSampler(H=data.H, W=data.W, focal=data.focal,
                           n_sample=n_sample, near=args.near, far=args.far)

    if args.paths == "auto":
        paths = (["xla", "pallas", "int8"] if device.type == "cuda"
                 else ["xla"])
    else:
        paths = [s.strip() for s in args.paths.split(",") if s.strip()]
    if not paths:
        raise SystemExit(f"--paths {args.paths!r} selects no inference "
                         "path — nothing would be verified")

    lpips_params = None
    if args.lpips_weights:
        from ..lpips import load_torch_lpips
        sd = torch.load(args.lpips_weights, map_location="cpu",
                        weights_only=True)
        lpips_params = load_torch_lpips(sd, net=args.lpips_net,
                                        device=device)
        print(f"LPIPS: {args.lpips_net} weights from {args.lpips_weights} "
              f"(rescale={args.lpips_rescale})")
    else:
        print("LPIPS: SKIPPED (no --lpips_weights; the torchvision-"
              "derived weights cannot ship offline — export once on a "
              "connected machine, see README)")
    results = {}
    for path in paths:
        if path == "xla":
            pcfg, use_pallas, quantize = cfg, False, ""
        elif path in ("pallas", "int8"):
            pcfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
            use_pallas, quantize = True, ("int8" if path == "int8" else "")
        else:
            raise SystemExit(f"unknown path {path!r}")
        if path != "xla" and not fused_kernel_supported(pcfg):
            # the frame would render the plain module: reporting it under
            # a kernel's label would be a false kernel-parity PASS
            print(f"[{path:7s}] SKIPPED — the fused kernels do not "
                  f"support this architecture (body_arch="
                  f"{pcfg.body_arch!r}, act {pcfg.act!r}/"
                  f"{pcfg.inact!r}); it would render the plain module "
                  "(same numbers as [xla])")
            results[path] = {"skipped": "fused kernel unsupported"}
            continue
        frame_fn = make_r2l_frame_fn(model, pcfg, sampler,
                                     embed_L=args.multires,
                                     use_pallas=use_pallas,
                                     quantize=quantize, calib_poses=poses)
        res = render_path(frame_fn, poses, gt_images=gt,
                          lpips_params=lpips_params,
                          lpips_rescale=args.lpips_rescale,
                          flip_rescale=args.flip_rescale)
        results[path] = {"psnr": res.test_psnr,
                         "psnr_v2": res.test_psnr_v2,
                         "ssim": res.test_ssim,
                         "flip": res.test_flip,
                         "lpips": res.test_lpips,
                         "kind": frame_fn.kind}
        lp = (f" LPIPS {res.test_lpips:.4f}"
              if res.test_lpips is not None else " LPIPS —")
        print(f"[{path:7s}] PSNR {res.test_psnr:.4f} "
              f"PSNRv2 {res.test_psnr_v2:.4f} SSIM {res.test_ssim:.4f} "
              f"FLIP {res.test_flip:.4f}{lp}")

    ok = True
    if not any("psnr" in r for r in results.values()):
        # every selected path was skipped: a no-op run must not read as
        # success, even in report-only mode
        ok = False
        print("FAIL: no selected path produced a PSNR (all skipped) — "
              "nothing was verified")
    if args.expect_psnr is not None:
        if not any("psnr" in r for r in results.values()):
            raise SystemExit("no selected path produced a PSNR to check "
                             "against --expect_psnr (all skipped)")
        for path, r in results.items():
            if "psnr" not in r:
                continue
            delta = r["psnr"] - args.expect_psnr
            # int8 is a lossy speed path: the bf16 target minus its
            # documented quality cost, not the 0.05 dB bar
            tol = args.tol if path != "int8" else max(args.tol, 0.5)
            good = delta >= -tol
            ok &= good
            print(f"[{path:7s}] expected {args.expect_psnr:.2f} dB, "
                  f"delta {delta:+.4f} dB (tol -{tol}) -> "
                  f"{'PASS' if good else 'FAIL'}")
    print(json.dumps({"ckpt": args.ckpt, "results": results,
                      "expect_psnr": args.expect_psnr, "tol": args.tol,
                      "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
