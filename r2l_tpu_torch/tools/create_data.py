"""Pseudo-data generation with the port (the reference's
`utils/create_data.py`), run on the CUDA card or, with ``--platform cpu``,
on the host.

Counterpart of ``tools/create_data.py``: the same flags (``configs.py``),
modes and files. Canonical use (README.md:79-91):

  python -m r2l_tpu_torch.tools.create_data --config configs/lego.txt \\
      --model_name nerf --teacher_ckpt <nerf ckpt> --create_data rand \\
      --n_pose_kd 10000 --datadir_kd data/nerf_synthetic/lego_pseudo

Modes (``datagen.py``): ``rand`` (ray shards; ``--quantize int8`` renders
with the int8 teacher), ``spiral_evenly_spaced`` (pseudo images + poses),
``rand_tworays``, ``3x3rays``, ``rand_images``, ``16x16patches[_v2,_v3]``,
and ``convert_rays`` (real train images -> ``<splits>_*.npy`` ray shards, the
reference's offline `utils/convert_original_data_to_rays_*.py`, with
``--splits``, ``--ignore`` and ``--donerf``). The teacher renders through
the fused kernel on the card (K6, K7 for int8). ``--test_teacher`` renders
the test split first and reports the teacher's PSNR (reference
`create_data.py:723-742`). A teacher checkpoint is required unless
``--allow_random_teacher``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..app import apply_platform, build_teacher, load_dataset, vol_config
from ..configs import parse_args
from ..data.rayshards import write_ray_shards
from ..datagen import (DataGenConfig, generate_3x3rays, generate_patches,
                       generate_pseudo_data, generate_pseudo_images,
                       generate_rand_images, generate_tworays,
                       images_to_ray_records)
from ..evaluate import make_nerf_frame_fn, render_path
from ..logging_ import Logger
from ..sampler import PointSampler

# The reference hand-codes this phi >= 0 exclusion list for ficus
# (`convert_original_data_to_rays_blender.py:114-115`).
FICUS_IGNORE = ("10,13,14,24,26,30,31,37,39,40,41,47,48,49,52,54,55,57,58,"
                "66,67,74,75,76,77,79,81,82,87,88,89,94,97,99")


def _frame_keep_mask(args, splits, split_ix, ignore_csv, logger):
    """Boolean keep-mask over the concatenated split indices, the
    reference's --ignore semantics: drop frames whose file_path index
    token is listed (`convert_original_data_to_rays_blender.py:106-121,
    133-141`, e.g. './train/r_3' -> token '3'). Blender datasets match
    the filename token; other dataset types fall back to the position
    within the split."""
    tokens = {t.strip() for t in ignore_csv.split(",") if t.strip()}
    masks = []
    for s in splits:
        n = len(split_ix[s])
        tj = os.path.join(args.datadir, f"transforms_{s}.json")
        if args.dataset_type == "blender" and os.path.isfile(tj):
            with open(tj) as f:
                frames = json.load(f)["frames"]
            # the loader's subsampling (data/blender.py)
            skip = (1 if s == "train" or args.testskip == 0
                    else args.testskip)
            frames = frames[::skip]
            assert len(frames) == n, (s, len(frames), n)
            m = np.array([fr["file_path"].split("_")[-1] not in tokens
                          for fr in frames], bool)
        else:
            m = np.array([str(i) not in tokens for i in range(n)], bool)
        masks.append(m)
    mask = np.concatenate(masks)
    if not mask.all():
        logger.print(f"--ignore: dropped {int((~mask).sum())} of "
                     f"{mask.size} frames")
    return mask


def convert_rays(args, ns, datadir_kd, logger, device) -> int:
    """Real train images -> ray shards. Student records store raw camera
    rays even for LLFF: the reference converter never NDC-warps
    (`convert_original_data_to_rays_llff.py:114-118`). Returns the rays
    written."""
    split_ix = {"train": ns.i_train, "val": ns.i_val, "test": ns.i_test}
    splits = [s.strip() for s in (args.splits or "train").split(",")
              if s.strip()]
    bad = [s for s in splits if s not in split_ix]
    if bad:
        raise SystemExit(f"ERROR: unknown --splits entries {bad} "
                         "(choose from train,val,test)")
    ignore = args.ignore
    if not ignore and "ficus" in args.datadir:
        ignore = FICUS_IGNORE
    idx = np.concatenate([np.asarray(split_ix[s]) for s in splits])
    if ignore:
        idx = idx[_frame_keep_mask(args, splits, split_ix, ignore, logger)]
    records = images_to_ray_records(
        ns.images[idx], ns.poses[idx], ns.H, ns.W, ns.focal, ndc=False,
        donerf=args.donerf, device=device)
    # shard prefix = ''.join(splits), the reference's naming rule
    # (`...blender.py:119-121`; only 'train_'-prefixed shards count as
    # real rays in the rays-mode dataset)
    paths = write_ray_shards(datadir_kd, records, prefix="".join(splits),
                             rng=np.random.default_rng(args.seed))
    logger.print(f"wrote {records.shape[0]} real rays "
                 f"({'+'.join(splits)}"
                 f"{', DONeRF ray convention' if args.donerf else ''}) "
                 f"to {len(paths)} shards in {datadir_kd}")
    return records.shape[0]


def main(argv=None) -> int:
    args = parse_args(argv)
    device = apply_platform(args)
    logger = Logger(experiment_name=args.experiment_name or "create_data",
                    experiments_dir=args.experiments_dir, debug=args.debug,
                    args=args)
    logger.print(f"device: {device}")
    ns = load_dataset(args, logger)
    datadir_kd = args.datadir_kd or (args.datadir + "_pseudo")
    if ":" in datadir_kd:
        # The reference's 'old:new' form (README.md:79; `create_data.py:744`
        # splits it): old seeds the new dir with the real train frames
        # because the reference's BlenderDataset reads ONE dir. Here the
        # images-mode dataset mixes real frames from --datadir directly, so
        # only the output half is needed.
        old, datadir_kd = datadir_kd.split(":", 1)
        logger.print(f"--datadir_kd 'old:new' reference form: writing to "
                     f"{datadir_kd!r} (real frames stay in --datadir; "
                     f"the {old!r} copy-seed step is unnecessary here)")

    if args.create_data == "convert_rays":
        convert_rays(args, ns, datadir_kd, logger, device)
        logger.close()
        return 0

    if not (args.teacher_ckpt or args.pretrained_ckpt):
        # The reference unconditionally loads --teacher_ckpt
        # (`create_data.py:289-296`); a random-init teacher makes junk
        # pseudo data. Hard error by default; the opt-out exists for
        # machinery smoke tests.
        if not args.allow_random_teacher:
            raise SystemExit(
                "ERROR: no --teacher_ckpt given — the teacher would be "
                "RANDOM-INIT and the generated pseudo data meaningless "
                "(the reference hard-requires it, create_data.py:289-"
                "296). Pass --teacher_ckpt <trained NeRF ckpt>, or "
                "--allow_random_teacher to proceed anyway (smoke tests).")
        logger.print(
            "WARNING: --allow_random_teacher — the teacher is RANDOM-"
            "INIT and the generated pseudo data is meaningless.")
    ncfg, ncfg_fine, mc, mf, _ = build_teacher(args, logger, device)
    vcfg = vol_config(args, ns)

    if args.test_teacher:
        sampler = PointSampler(H=ns.H, W=ns.W, focal=ns.focal,
                               n_sample=args.N_samples,
                               near=ns.near, far=ns.far)
        frame_fn = make_nerf_frame_fn(
            mc, mf, ncfg, vcfg, sampler,
            (ns.H, ns.W, ns.focal) if ns.ndc else None,
            use_pallas=args.use_pallas, ncfg_fine=ncfg_fine,
            perturb_test=args.perturb_test > 0, device=device)
        res = render_path(frame_fn, ns.poses[ns.i_test],
                          gt_images=ns.images[ns.i_test],
                          compute_flip=False, logger=logger)
        logger.print(f"teacher test PSNR {res.test_psnr:.4f} "
                     f"({frame_fn.kind})")

    if args.rm_existing_data and os.path.isdir(datadir_kd):
        # npz too: rand_images/patches write .npz batches — stale
        # old-teacher data must not survive an explicit wipe
        for f in os.listdir(datadir_kd):
            if f.endswith((".npy", ".npz")) and not f.startswith("train_"):
                os.remove(os.path.join(datadir_kd, f))

    n_pose = args.n_pose_kd if args.n_pose_kd else 100
    # Ray-record modes loop over a pose count; only spiral takes the
    # [n_theta, n_phi, n_radius] grid list.
    if (not isinstance(n_pose, int)
            and args.create_data != "spiral_evenly_spaced"):
        raise SystemExit(f"--n_pose_kd must be an int for "
                         f"--create_data {args.create_data!r}; "
                         f"got {n_pose!r}")
    gcfg = DataGenConfig(
        n_pose=n_pose if isinstance(n_pose, int) else 1,
        H=ns.H, W=ns.W, focal=ns.focal,
        use_rand_focal=args.use_rand_focal,
        learn_depth=args.learn_depth,
        save_every=args.create_data_chunk, seed=args.seed,
        poses_per_batch=args.poses_per_batch,
        use_pallas=args.use_pallas,
        quantize=args.quantize, max_save=args.max_save)
    kw = dict(ncfg_fine=ncfg_fine, device=device)
    mode = args.create_data
    if mode == "rand":
        pose_fn = None
        if args.dataset_type == "llff":
            from ..data.llff import get_rand_pose_llff
            hwf = np.array([ns.H, ns.W, ns.focal], np.float32)
            poses35 = np.concatenate(
                [ns.poses, np.broadcast_to(hwf.reshape(3, 1),
                                           (len(ns.poses), 3, 1))], -1)
            pose_fn = lambda r: get_rand_pose_llff(r, poses35)[:, :4]  # noqa: E731
        total = generate_pseudo_data(
            mc, mf, ncfg, vcfg, gcfg, datadir_kd, pose_fn=pose_fn,
            ndc=ns.ndc, progress=lambda i, n: (i % 50 == 0 and logger.print(
                f"pose {i}/{n}")), **kw)
        logger.print(f"generated {total} pseudo rays in {datadir_kd}")
    elif mode == "spiral_evenly_spaced":
        n = generate_pseudo_images(mc, mf, ncfg, vcfg, gcfg, datadir_kd,
                                   n_pose=n_pose, **kw)
        logger.print(f"generated {n} pseudo images in {datadir_kd}")
    elif mode == "rand_tworays":
        n = generate_tworays(mc, mf, ncfg, vcfg, gcfg, datadir_kd, **kw)
        logger.print(f"generated {n} two-ray records in {datadir_kd}")
    elif mode == "3x3rays":
        n = generate_3x3rays(mc, mf, ncfg, vcfg, gcfg, datadir_kd, **kw)
        logger.print(f"generated {n} 3x3 records in {datadir_kd}")
    elif mode == "rand_images":
        n = generate_rand_images(mc, mf, ncfg, vcfg, gcfg, datadir_kd, **kw)
        logger.print(f"generated {n} pseudo image records in {datadir_kd}")
    elif mode in ("16x16patches", "16x16patches_v2", "16x16patches_v3"):
        n = generate_patches(mc, mf, ncfg, vcfg, gcfg, datadir_kd, **kw)
        logger.print(f"generated {n} patch frames in {datadir_kd}")
    else:
        raise SystemExit(f"unsupported --create_data {mode!r} "
                         "(supported: rand, spiral_evenly_spaced, "
                         "rand_tworays, 3x3rays, rand_images, "
                         "16x16patches[_v2,_v3], convert_rays)")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
