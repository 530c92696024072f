"""volta_tpu_torch: the PyTorch and CUDA port of VOLTA-TPU for NVIDIA Hopper.

It serves the ctrl_uniter VQA eval path (``python -m
volta_tpu_torch.eval_task``) through hand-written CUDA kernels, held against
the JAX package ``volta_tpu``, whose JAX-free modules (``config``, ``zoo``,
``data``) it imports instead of copying. Importing it imports no JAX and
builds no kernel.
"""

from volta_tpu.config import SublayerSpec, VoltaConfig

from .models import VoltaForVLTasks, VoltaModel

__version__ = "0.1.0"

__all__ = ["VoltaConfig", "SublayerSpec", "VoltaModel", "VoltaForVLTasks"]
