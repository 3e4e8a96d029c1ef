"""Export a native .msgpack checkpoint as a reference-schema torch .tar.

Counterpart of ``tools/export_torch_ckpt.py``, with the same flags and the
same output: the reference's ``network_fn_state_dict`` (and
``network_fine_state_dict`` for a teacher with a fine network),
``global_step``, ``best_psnr``, ``best_psnr_step`` and a ``note`` (schema of
reference ``main.py:1516-1542``). The optimizer state and the pickled
module (``network_fn``) are not written.

  # student (R2L)
  python -m r2l_tpu_torch.tools.export_torch_ckpt \\
      --ckpt weights/ckpt_best.msgpack --out lego.tar

  # teacher (NeRF; viewdirs and the fine network read from the tree)
  python -m r2l_tpu_torch.tools.export_torch_ckpt \\
      --ckpt weights/teacher.msgpack --out teacher.tar --model_name nerf
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..models._layout import restore_lists
from ..models.nerf import NeRFConfig


def _teacher_cfg(tree: dict) -> NeRFConfig:
    w0 = np.asarray(tree["pts_linears"][0]["w"])
    return NeRFConfig(D=len(tree["pts_linears"]), W=int(w0.shape[1]),
                      use_viewdirs="alpha_linear" in tree,
                      input_ch=int(w0.shape[0]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="native .msgpack checkpoint (trainer layout)")
    p.add_argument("--out", required=True, help="output .tar path")
    p.add_argument("--model_name", default="R2L", choices=["R2L", "nerf"],
                   help="R2L student or NeRF teacher checkpoint "
                        "(viewdirs and fine-net presence are inferred "
                        "from the checkpoint tree)")
    p.add_argument("--linear_tail", action="store_true", default=False,
                   help="the student was trained with --linear_tail: "
                        "export the tail under the reference's "
                        "'tail.*' keys instead of 'tail.0.*' (shape-"
                        "identical, not inferable from the tree)")
    args = p.parse_args(argv)

    raw, meta = ckpt.load_checkpoint(args.ckpt)
    ckpt.drop_cached_checkpoint()
    blob = {"global_step": int(meta.get("global_step", 0)),
            "best_psnr": float(meta.get("best_psnr", -1.0)),
            "best_psnr_step": int(meta.get("best_psnr_step", -1))}

    def to_t(sd):
        return {k: torch.from_numpy(np.array(v, np.float32, copy=True))
                for k, v in sd.items()}

    if args.model_name == "nerf":
        for key, name in (("coarse", "network_fn_state_dict"),
                          ("fine", "network_fine_state_dict")):
            if raw.get(key):
                tree = restore_lists(raw[key])
                blob[name] = to_t(ckpt.params_to_torch_nerf(
                    tree, _teacher_cfg(tree)))
    else:
        params = restore_lists(raw["params"] if "params" in raw else raw)
        cfg = ckpt.infer_r2l_config_from_params(
            params, linear_tail=args.linear_tail)
        blob["network_fn_state_dict"] = to_t(
            ckpt.params_to_torch_r2l(params, cfg))
    n_par = sum(int(v.numel())
                for key in ("network_fn_state_dict",
                            "network_fine_state_dict")
                for v in blob.get(key, {}).values())
    blob["note"] = ("exported from a native r2l_tpu checkpoint; "
                    "optimizer state / pickled module omitted "
                    "(torch-specific in the reference)")
    torch.save(blob, args.out)
    print(f"wrote {args.out}: {n_par/1e6:.2f}M params, "
          f"global_step {blob['global_step']}, "
          f"best_psnr {blob['best_psnr']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
