"""The command line and config files of the port: the flags of
``r2l_tpu/configs.py``, every one with the same default and choices.

Counterpart of ``r2l_tpu/configs.py`` (``build_parser`` :35,
``read_config_file`` :346, ``parse_args`` :368, ``_check_n_pose`` :412,
``normalize_args`` :439, ``_warn_vestigial`` :492, ``args_to_r2l_config``
:526, ``parse_mesh_spec`` :576), copied because the JAX package is not
imported here. The 57 scene files under ``configs/`` parse to the same
namespace with either package. The reference's surface (a configargparse
singleton, `option.py:6-358` and the logging flags of
`smilelogging/__init__.py:9-40`) is stdlib argparse plus a ``key = value``
reader, with the reference's post-parse normalization (`option.py:360-386`):

  * ``--trial.xxx`` dotted flags collapse into an ``args.trial`` namespace
    when ``--trial.ON`` is set (`smilelogging/slutils.py:176-188`);
  * ``n_pose_kd`` / ``n_pose_video``: int or comma list;
  * ``hard_ratio``: scalar or ``in,out`` pair;
  * ``video_tag`` default derived from ``n_pose_video``.

The flags added by the JAX package (mesh axes, compute dtype, the kernel
toggle, ...) keep their text; how the port reads them is ``app.py``'s:
``--platform auto`` is the card, ``cpu`` the CPU, ``tpu`` an error, and the
multi-device flags (``--mesh``, ``--multihost``, ``--num_cpu_devices`` > 1)
raise. ``args_to_r2l_config`` builds the port's ``R2LConfig``, the compute
dtype as a torch dtype.
"""
from __future__ import annotations

import argparse
import os
import shlex
import sys
from typing import Sequence


class TrialNamespace:
    """Attribute bag for the collapsed ``--trial.*`` flags."""
    def __repr__(self):
        return f"TrialNamespace({self.__dict__})"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("r2l_tpu_torch",
                                fromfile_prefix_chars=None)
    add = p.add_argument

    add('--config', type=str, default='', help='config file path')
    add('--expname', type=str, default='', help='experiment name')
    add('--basedir', type=str, default='./logs/')
    add('--datadir', type=str, default='./data/llff/fern')

    # training options
    add('--netdepth', type=int, default=8)
    add('--netwidth', type=int, default=256)
    add('--netdepth_fine', type=int, default=8)
    add('--netwidth_fine', type=int, default=256)
    add('--N_rand', type=int, default=32 * 32 * 4)
    add('--lrate', type=float, default=5e-4)
    add('--lrate_decay', type=int, default=250)
    add('--chunk', type=int, default=1024 * 32)
    add('--netchunk', type=int, default=1024 * 64)
    add('--no_batching', type=_bool, nargs='?', const=True, default=False)
    add('--no_reload', type=_bool, nargs='?', const=True, default=False)
    add('--ft_path', type=str, default=None)

    # rendering options
    add('--N_samples', type=int, default=64)
    add('--N_importance', type=int, default=0)
    add('--perturb', type=float, default=1.)
    add('--perturb_test', type=float, default=0.)
    add('--use_viewdirs', type=_bool, nargs='?', const=True, default=False)
    add('--i_embed', type=int, default=0)
    add('--multires', type=int, default=10)
    add('--multires_views', type=int, default=4)
    add('--raw_noise_std', type=float, default=0.)
    add('--render_only', type=_bool, nargs='?', const=True, default=False)
    add('--render_test', type=_bool, nargs='?', const=True, default=False)
    add('--render_factor', type=float, default=0)

    add('--precrop_iters', type=int, default=0)
    add('--precrop_frac', type=float, default=.5)

    # dataset options
    add('--dataset_type', type=str, default='llff',
        choices=['llff', 'blender', 'deepvoxels'])
    add('--testskip', type=int, default=8)
    add('--shape', type=str, default='greek')
    add('--white_bkgd', type=_bool, nargs='?', const=True, default=False)
    add('--half_res', type=_bool, nargs='?', const=True, default=False)
    add('--factor', type=int, default=8)
    add('--no_ndc', type=_bool, nargs='?', const=True, default=False)
    add('--lindisp', type=_bool, nargs='?', const=True, default=False)
    add('--spherify', type=_bool, nargs='?', const=True, default=False)
    add('--llffhold', type=int, default=8)

    # logging/saving
    add('--i_print', type=int, default=100)
    add('--i_img', type=int, default=500)
    add('--i_weights', type=int, default=10000)
    add('--i_testset', type=int, default=2000)
    add('--i_video', type=int, default=10000)

    # R2L related
    add('--model_name', type=str, default='R2L',
        choices=['nerf', 'nerf_v3.2', 'R2L'])
    add('--N_iters', type=int, default=200000)
    add('--skips', type=str, default='4')
    add('--D_head', type=int, default=4)
    add('--n_sample_per_ray', type=int, default=192)
    add('--encode_input', type=_bool, nargs='?', const=True, default=False)
    add('--pretrained_ckpt', type=str, default='')
    add('--test_pretrained', type=_bool, nargs='?', const=True, default=False)
    add('--resume', type=_bool, nargs='?', const=True, default=False)
    add('--lw_kd', type=float, default=0.001)
    add('--split_layer', type=int, default=-1)
    add('--dropout_layer', type=str, default='')
    add('--dropout_ratio', type=float, default=0.5)
    add('--n_pose_video', type=str, default='40')
    add('--n_pose_kd', type=str, default='100')
    add('--video_tag', type=str, default='')
    add('--video_poses_perturb', type=_bool, nargs='?', const=True,
        default=False)
    add('--datadir_kd', type=str, default='')
    add('--create_data_chunk', type=int, default=100)
    add('--create_data', type=str, default='spiral_evenly_spaced',
        help="pseudo-data mode: 'rand' (flat ray shards, the R2L "
             "training input) or 'spiral_evenly_spaced' (pseudo images). "
             "'rand_images' output IS trainable here (--data_mode rays "
             "reads the [H,W,9] frames, optionally cropped via "
             "--rand_crop_size) — the reference only had dead code for "
             "it. 'rand_tworays'/'3x3rays'/'16x16patches*' remain "
             "GENERATOR-ONLY, as in the reference: their consuming "
             "student architectures were never released "
             "(`create_data.py:874-1333`)")
    add('--no_rand_focal', dest='use_rand_focal', action='store_false',
        default=True)
    add('--max_save', type=int, default=40000)
    add('--i_update_data', type=int, default=1000000000)
    add('--pseudo_ratio', type=float, default=-1.)
    add('--trans_origin', type=str, default='')
    add('--select_pixel_mode', type=str, default='rand_pixel',
        choices=['rand_pixel', 'rand_patch'])
    add('--freeze_pretrained', type=_bool, nargs='?', const=True,
        default=False)
    add('--focal_scale', type=float, default=1.)
    add('--data_mode', type=str, default='images', choices=['images', 'rays'])
    add('--rm_existing_data', type=_bool, nargs='?', const=True,
        default=False)
    # offline ray-converter options (reference
    # `utils/convert_original_data_to_rays_{blender,llff}.py:101-110`;
    # consumed by tools/create_data.py --create_data convert_rays)
    add('--splits', type=str, default='train',
        help="convert_rays: comma list of splits to convert "
             "(train,val,test). Shard prefix is ''.join(splits) — only "
             "'train_'-prefixed shards count as REAL rays in rays-mode "
             "training, matching the reference's naming rule")
    add('--ignore', type=str, default='',
        help='convert_rays: comma list of frame index tokens to skip '
             "(blender: the file_path suffix, './train/r_3' -> '3'); "
             "auto-set for ficus like the reference")
    add('--donerf', type=_bool, nargs='?', const=True, default=False,
        help='convert_rays: generate rays in the DONeRF direction '
             'convention (half-pixel-centered, unit-norm) so shards '
             'line up with --given_render_path_rays eval rays')
    add('--num_workers', type=int, default=8)
    add('--hard_ratio', type=str, default='')
    add('--hard_mul', type=float, default=1)
    add('--use_residual', type=_bool, nargs='?', const=True, default=False)
    add('--linear_tail', type=_bool, nargs='?', const=True, default=False)
    add('--layerwise_netwidths', type=str, default='')
    add('--layerwise_netwidths2', type=str, default='')
    add('--render_iters', type=int, default=1)
    add('--convert_to_onnx', type=_bool, nargs='?', const=True,
        default=False, help='export the model (StableHLO/TF SavedModel '
        'on this framework) + run the numerical parity check')
    add('--benchmark', type=_bool, nargs='?', const=True, default=False)
    add('--use_bn', type=_bool, nargs='?', const=True, default=False)
    add('--shuffle_input', type=_bool, nargs='?', const=True, default=False)
    add('--kernel_size', type=int, default=1)
    add('--padding', type=int, default=0)
    add('--body_arch', type=str, default='conv', choices=['conv', 'resblock'])
    add('--lw_rgb', type=float, default=1)
    add('--lw_rgb1', type=float, default=1)
    add('--act', type=str, default='relu', choices=['relu', 'lrelu'])
    add('--warmup_lr', type=str, default='')
    add('--lpips_net', type=str, default='alex')
    add('--pseudo_data_hold_ratio', type=float, default=0)
    add('--given_render_path_rays', type=str, default='')
    add('--learn_depth', type=str, default='',
        choices=['', 'depth', 'surface'])
    add('--lw_depth', type=float, default=0.1)
    add('--save_intermediate_models', type=_bool, nargs='?', const=True,
        default=False)
    add('--plucker', type=_bool, nargs='?', const=True, default=False)

    # create data
    add('--teacher_ckpt', type=str, default=None)
    add('--test_teacher', type=_bool, nargs='?', const=True, default=False)

    # trial.* dotted sub-namespace
    add('--trial.ON', type=_bool, nargs='?', const=True, default=False)
    add('--trial.body_arch', type=str, default='mlp',
        choices=['mlp', 'resmlp'])
    add('--trial.res_scale', type=float, default=1.)
    add('--trial.n_learnable', type=int, default=2)
    add('--trial.inact', type=str, default='relu',
        choices=['none', 'relu', 'lrelu'])
    add('--trial.outact', type=str, default='none',
        choices=['none', 'relu', 'lrelu'])
    add('--trial.n_block', type=int, default=-1)
    add('--trial.near', type=float, default=-1)
    add('--trial.far', type=float, default=-1)

    # logging-runtime flags (reference smilelogging surface)
    add('--experiment_name', type=str, default='')
    add('--experiments_dir', type=str, default='Experiments')
    add('--debug', type=_bool, nargs='?', const=True, default=False)
    add('--no_cache', type=_bool, nargs='?', const=True, default=False)
    add('--cache_code', type=str, default='')
    add('--no_scp', type=_bool, nargs='?', const=True, default=False)
    add('--resume_TimeID', type=str, default='')
    add('--sl.ON', type=_bool, nargs='?', const=True, default=False)
    add('--sl.config', type=str, default='.smilelogging_cfg')

    # --- flags the JAX package added (not in the reference) ---
    add('--mesh', type=str, default='',
        help="multi-device axes in the JAX package; not ported here "
             "(ROADMAP A6): any value raises")
    add('--compute_dtype', type=str, default='float32',
        choices=['float32', 'bfloat16'],
        help='activation dtype for the R2L student (f32 renders through '
             'K1 f32, bf16 through K1 bf16)')
    add('--matmul_precision', type=str, default='high',
        choices=['default', 'high', 'highest'],
        help="the JAX package's f32 matmul precision; accepted and "
             "ignored here (the kernels' f32 products are 3xTF32, the "
             "plain paths full f32)")
    add('--use_pallas', type=_bool, nargs='?', const=True, default=True,
        help='use the fused inference kernels (K1/K2, K6/K7) when '
             'rendering')
    add('--pallas_tile', type=int, default=800)
    add('--poses_per_batch', type=int, default=8,
        help='poses per device render in create_data --create_data rand')
    add('--quantize', type=str, default='', choices=['', 'int8'],
        help='int8: static-scale quantized inference kernel (K2; per-'
             'channel weight scales, per-(layer, channel) activation '
             'scales calibrated on sample rays at build time)')
    add('--seed', type=int, default=0)
    add('--ckpt_format', type=str, default='native',
        choices=['native', 'torch'],
        help='checkpoint format for --pretrained_ckpt / --teacher_ckpt')
    add('--export_dir', type=str, default='',
        help='output dir for --convert_to_onnx (ONNX export)')
    add('--multihost', type=_bool, nargs='?', const=True, default=False,
        help="multi-host runs in the JAX package; not ported here "
             "(ROADMAP A6): raises")
    add('--pseudo_ratio_schedule', type=str, default='',
        help="linear pseudo/real mixing schedule, e.g. '1:0.2,500000:0.9' "
             "(reference get_pseudo_ratio, main.py:811-828); overrides "
             "--pseudo_ratio when set")
    add('--lpips_weights', type=str, default='',
        help='path to a torch lpips state_dict (.pt/.pth) to enable the '
             'LPIPS metric during eval (weights are not bundled)')
    add('--profile_dir', type=str, default='',
        help='write a torch.profiler trace here during training/render')
    add('--fused_train_vjp', type=_bool, nargs='?', const=True,
        default=False,
        help='route distillation forward+backward through the fused '
             'training kernels (K3 forward, K5 backward; single device, '
             'canonical resmlp body, netwidth % 128 == 0)')
    add('--fused_train_int8', type=_bool, nargs='?', const=True,
        default=False,
        help='with --fused_train_vjp: run the training forward in int8 '
             '(K4; static scales recalibrated from the live params each '
             'step; int8 activation stash; straight-through backward)')
    add('--fused_calib_every', type=int, default=1,
        help='with --fused_train_int8 and --steps_per_dispatch > 1: '
             'recalibrate the int8 scales every N global steps instead '
             'of inside every step (scales at most N-1 steps stale; 1 is '
             'exact)')
    add('--hard_sample_mode', type=str, default='stratified',
        choices=['stratified', 'permutation'],
        help='hard-pool draw: "stratified" picks one slot per stratum '
             '(distinct, O(n)), "permutation" is the reference\'s '
             'exact uniform subset (full-pool sort)')
    add('--debug_nans', type=_bool, nargs='?', const=True, default=False,
        help="turn on torch's anomaly mode and check every step's loss "
             "for NaN/Inf (the reference keeps set_detect_anomaly always "
             "on; here it is opt-in)")
    add('--steps_per_dispatch', type=int, default=0,
        help='train K optimizer steps per loop turn (0 = 1); the same '
             'result as K single steps')
    add('--rand_crop_size', type=int, default=-1,
        help='with image-shaped ray shards (rand_images_*.npz in '
             '--datadir_kd, --data_mode rays): train on a random SxS '
             'crop per draw instead of the whole frame — the reference '
             "BlenderDataset_v2's rand_crop_size branch "
             '(dataset/load_blender.py:306-317), which its CLI never '
             'exposed; -1 = whole frame')
    add('--platform', type=str, default='auto',
        choices=['auto', 'cpu', 'tpu'],
        help="'auto' runs on the CUDA card and raises without one, 'cpu' "
             "runs the whole CLI on the host (the kernels' plain "
             "versions), 'tpu' raises (the JAX package's)")
    add('--num_cpu_devices', type=int, default=0,
        help='virtual host devices in the JAX package; values above 1 '
             'raise here (ROADMAP A6)')
    add('--lpips_rescale', type=str, default='standard',
        choices=['standard', 'minmax'],
        help="LPIPS input rescale: 'standard' maps [0,1] via 2x-1 (the "
             "original LPIPS convention); 'minmax' reproduces the "
             "reference's per-tensor min-max rescale to [-1,1] "
             "(main.py:361-364) so numbers are comparable to reference "
             "logs")
    add('--flip_rescale', type=str, default='standard',
        choices=['standard', 'minmax'],
        help="FLIP input convention: 'standard' feeds [0,1] sRGB (the "
             "FLIP spec); 'minmax' reproduces the reference, which "
             "min-max rescales BOTH frame stacks to [-1,1] before "
             "compute_flip (main.py:361-377) — use it when comparing "
             "against reference log lines")
    add('--save_testset', type=_bool, nargs='?', const=True, default=True,
        help='write every rendered test frame (+gt and |err| images) to '
             'gen_img/testset_iter<i>/ at each --i_testset eval, as the '
             'reference does (main.py:1443-1454); --save_testset 0 '
             'skips the disk writes for IO-constrained runs')
    add('--allow_random_teacher', type=_bool, nargs='?', const=True,
        default=False,
        help='create_data only: proceed WITHOUT --teacher_ckpt (random-'
             'init teacher -> meaningless pseudo data; the reference '
             'hard-requires the ckpt, create_data.py:289-296). Default '
             'is a hard error; this opt-out exists for machinery smoke '
             'tests')
    return p


def _bool(v: str | bool) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "y", "on")


def read_config_file(path: str) -> dict[str, str]:
    """Parse a reference-style ``key = value`` config file.

    Inline ``#`` comments and blank lines are ignored
    (configargparse semantics, e.g. `configs/lego.txt`).
    """
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split('#', 1)[0].strip()
            if not line:
                continue
            if '=' in line:
                k, v = line.split('=', 1)
            elif ':' in line:
                k, v = line.split(':', 1)
            else:
                k, v = line, 'True'
            out[k.strip()] = v.strip()
    return out


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    """Parse CLI args with ``--config`` file support + post-parse fixups."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()

    # First pass: find --config and fold the file's values in as defaults
    # (CLI always wins, as with configargparse).
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--config', type=str, default='')
    known, _ = pre.parse_known_args(argv)
    if known.config:
        file_vals = read_config_file(known.config)
        by_dest = {a.dest: a for a in parser._actions}
        by_flag = {}
        for a in parser._actions:
            for s in a.option_strings:
                by_flag[s.lstrip('-')] = a
        defaults = {}
        for k, v in file_vals.items():
            action = by_flag.get(k) or by_dest.get(k)
            if action is None:
                raise SystemExit(f"unknown config key {k!r} in {known.config}")
            if isinstance(action, argparse._StoreFalseAction):
                # store_false flags: 'no_rand_focal = True' (the FLAG
                # name) means the same as passing the flag, i.e. dest
                # becomes False — but 'use_rand_focal = True' (the DEST
                # name, matched via the by_dest fallback) must be taken
                # literally, not inverted.
                if k in by_flag:
                    defaults[action.dest] = not _bool(v)
                else:
                    defaults[action.dest] = _bool(v)
            elif action.const is True or isinstance(action.default, bool):
                defaults[action.dest] = _bool(v)
            elif action.type is not None:
                defaults[action.dest] = action.type(v)
            else:
                defaults[action.dest] = v
        parser.set_defaults(**defaults)

    args = parser.parse_args(argv)
    return normalize_args(args)


def _check_n_pose(n_pose):
    """int string -> int; comma list -> list of ints (or 'mode:value'
    strings); 'none' -> None (reference `option.py:366-373`). A bare
    non-integer scalar ('40.0', '-5') is rejected HERE rather than as a
    ValueError deep inside get_novel_poses."""
    if n_pose is None or str(n_pose).lower() == 'none':
        return None
    s = str(n_pose)
    if s.isdigit():
        return int(s)
    if ',' not in s and ':' not in s:
        raise SystemExit(
            f"--n_pose_kd/--n_pose_video expects an int, a comma list "
            f"like '4,2,1', or 'mode:value' items — got {s!r}")
    items = [int(p) if p.isdigit() else p for p in s.split(',')]
    # A list value must name all three axes (theta, phi, radius) —
    # get_novel_poses indexes n_pose[1]/n_pose[2], so a 1- or 2-item
    # list (e.g. a lone 'fix:90') would IndexError deep inside pose
    # synthesis instead of failing here.
    if len(items) != 3:
        raise SystemExit(
            f"--n_pose_kd/--n_pose_video list form needs exactly 3 items "
            f"(theta, phi, radius; ints or 'mode:value') — got "
            f"{len(items)} in {s!r}")
    return items


def normalize_args(args: argparse.Namespace) -> argparse.Namespace:
    """Reference post-parse normalization (`option.py:360-386` +
    `slutils.py:176-188` update_args)."""
    if args.video_tag == '':
        args.video_tag = f'pose{args.n_pose_video}'
    args.n_pose_kd = _check_n_pose(args.n_pose_kd)
    args.n_pose_video = _check_n_pose(args.n_pose_video)

    if args.hard_ratio != '':
        if ',' not in str(args.hard_ratio):
            args.hard_ratio = float(args.hard_ratio)
        else:
            args.hard_ratio = [float(x)
                               for x in str(args.hard_ratio).split(',')]

    # Collapse dotted trial.* flags into args.trial when trial.ON.
    dotted = {k: v for k, v in vars(args).items() if '.' in k}
    for k in dotted:
        delattr(args, k)
    if dotted.get('trial.ON'):
        trial = TrialNamespace()
        for k, v in dotted.items():
            setattr(trial, k.split('.', 1)[1], v)
        args.trial = trial
    if dotted.get('sl.ON'):
        # smilelogging's own dotted namespace: the reference collapses it
        # too but nothing in R2L ever reads args.sl (grep: only the
        # definitions, smilelogging/__init__.py:36-40) — vestigial.
        print("WARNING: --sl.ON/--sl.config are accepted for reference "
              "CLI parity but are vestigial (the reference never reads "
              "args.sl) — they have NO effect.", file=sys.stderr)
    _warn_vestigial(args)
    return args


# Flags the REFERENCE parses but never reads anywhere in its code (verified
# by grep over the reference: e.g. args.use_bn / args.lw_kd have zero use
# sites outside option.py). We keep accepting them for CLI-surface parity —
# a script written for the reference must still run — but never silently:
# any non-default value gets a loud warning naming the flag a no-op.
_VESTIGIAL = {
    'use_bn': False, 'kernel_size': 1, 'padding': 0, 'split_layer': -1,
    'dropout_layer': '', 'dropout_ratio': 0.5, 'lw_kd': 0.001, 'D_head': 4,
    'encode_input': False, 'lw_rgb1': 1,
    'video_poses_perturb': False, 'layerwise_netwidths2': '',
    'body_arch': 'conv',  # the non-trial CNN-body flag; R2L uses trial.*
    'no_reload': False,   # ref parses but never reads (grep option.py only)
    'ft_path': None,      # ref parses but never reads
    'basedir': './logs/',  # superseded by smilelogging exp dirs in the ref
    'no_scp': False,      # ref smilelogging scp upload; nothing scps here
}


def _warn_vestigial(args) -> None:
    for flag, default in _VESTIGIAL.items():
        val = getattr(args, flag, default)
        if flag == 'basedir':
            # path-normalize: './logs' == './logs/' (the generated scene
            # configs write it without the trailing slash)
            if os.path.normpath(str(val)) == os.path.normpath(str(default)):
                continue
        if val != default:
            print(f"WARNING: --{flag} is accepted for reference CLI parity "
                  f"but is vestigial (the reference never reads it) — "
                  f"it has NO effect.", file=sys.stderr)
    if args.shuffle_input:
        # The reference's --shuffle_input block permutes a size-1 group
        # (`torch.randperm(3 // 3)`, main.py:1313-1322) — an exact no-op.
        print("WARNING: --shuffle_input matches the reference exactly: "
              "its shuffle block permutes a size-1 group (main.py:1313-"
              "1322) and therefore has NO effect.", file=sys.stderr)
    if args.netchunk != 1024 * 64:
        # The reference slices MLP forwards into netchunk points
        # (`main.py:51-62`); here the network runs on a whole ray chunk
        # at once, so memory is controlled by --chunk alone.
        print("WARNING: --netchunk has no counterpart here — the network "
              "runs on whole ray chunks; use --chunk to bound render "
              "memory.", file=sys.stderr)
    if args.cache_code:
        # Reference: a user shell script that caches the code tree
        # (`logger.py:514-528`). Here the Logger zips the source tree
        # itself (logging_.cache_code); the script path is ignored.
        print("WARNING: --cache_code script is ignored — the Logger "
              "snapshots the source tree to .caches/code.zip itself "
              "(disable with --no_cache).", file=sys.stderr)


def args_to_r2l_config(args):
    """Map parsed flags -> the port's R2LConfig (reference create_nerf
    semantics, `main.py:455-462`: input_dim from n_sample_per_ray x 3 x
    (2L+1), or 6x(2L+1) for Plücker). ``--compute_dtype`` becomes
    ``torch.bfloat16`` or ``torch.float32``; ``--matmul_precision`` has no
    counterpart (f32 products are full f32, or 3xTF32 in the kernels)."""
    import torch

    from .models.r2l import R2LConfig

    L = args.multires
    per = 2 * L + 1
    input_dim = (6 * per if args.plucker
                 else args.n_sample_per_ray * 3 * per)
    trial = getattr(args, 'trial', None)
    body_arch = getattr(trial, 'body_arch', 'mlp') if trial else 'mlp'
    layerwise = ()
    if args.layerwise_netwidths:
        layerwise = tuple(int(x)
                          for x in str(args.layerwise_netwidths).split(','))
        if body_arch == 'resmlp':
            # In the reference the resmlp body ignores the list but the
            # tail is still built from Ws[D-2] and would crash on a width
            # mismatch (`model/nerf_raybased.py:489-537`) — reject early.
            raise SystemExit('--layerwise_netwidths applies to the plain '
                             'MLP body only (trial.body_arch=mlp)')
    return R2LConfig(
        input_dim=input_dim,
        # extra regression channels: scalar depth (1) or the surface
        # point o + d*depth (3) — matches the datagen record layout
        # (reference `create_data.py:832-836`)
        output_dim=3 + {"": 0, "depth": 1,
                        "surface": 3}[args.learn_depth or ""],
        netdepth=args.netdepth,
        netwidth=args.netwidth,
        n_block=getattr(trial, 'n_block', -1) if trial else -1,
        n_learnable=getattr(trial, 'n_learnable', 2) if trial else 2,
        act=args.act,
        inact=getattr(trial, 'inact', 'relu') if trial else 'relu',
        outact=getattr(trial, 'outact', 'none') if trial else 'none',
        res_scale=getattr(trial, 'res_scale', 1.0) if trial else 1.0,
        body_arch=body_arch if body_arch in ('resmlp', 'mlp') else 'mlp',
        layerwise_widths=layerwise,
        use_residual=args.use_residual,
        linear_tail=args.linear_tail,
        compute_dtype=(torch.bfloat16 if args.compute_dtype == 'bfloat16'
                       else torch.float32),
    )


def parse_mesh_spec(spec: str) -> dict[str, int] | None:
    """'data:4,model:2' -> {'data': 4, 'model': 2}; '' -> None."""
    if not spec:
        return None
    out = {}
    for part in spec.split(','):
        name, _, size = part.partition(':')
        out[name.strip()] = int(size) if size else -1
    return out
