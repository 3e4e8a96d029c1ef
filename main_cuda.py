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
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from r2l_tpu_torch.app import train  # noqa: E402
from r2l_tpu_torch.configs import parse_args  # noqa: E402

if __name__ == "__main__":
    train(parse_args())
