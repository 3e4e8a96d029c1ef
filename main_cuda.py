"""The command line of the PyTorch/CUDA port (``r2l_tpu_torch``): the same
invocations as ``main.py`` (teacher training, distillation,
``--render_only``, ``--benchmark``, ``--convert_to_onnx``), run on the CUDA
card, or on the host with ``--platform cpu``:

  python main_cuda.py --model_name R2L --config configs/lego_noview.txt \
      --n_sample_per_ray 16 --netwidth 256 --netdepth 88 \
      --use_residual --trial.ON --trial.body_arch resmlp \
      --render_only --render_test --pretrained_ckpt <ckpt>

Without a card and without ``--platform cpu`` it exits with an error.
Pseudo data: ``python -m r2l_tpu_torch.tools.create_data``.

Several cards: ``torchrun --nproc_per_node N main_cuda.py --mesh data:N
...`` (one NCCL rank per card). On the host, ``--platform cpu
--num_cpu_devices N [--mesh data:N]`` starts N gloo ranks of this command.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from r2l_tpu_torch.app import train  # noqa: E402
from r2l_tpu_torch.configs import parse_args  # noqa: E402
from r2l_tpu_torch.parallel.dist import python_entry, run_cli  # noqa: E402

if __name__ == "__main__":
    argv = sys.argv[1:]
    args = parse_args(argv)
    rc = run_cli(argv, python_entry(__file__), args.platform,
                 args.num_cpu_devices)
    if rc is None:
        train(args)
        rc = 0
    sys.exit(rc)
