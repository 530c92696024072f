"""volta_tpu_torch: the PyTorch and CUDA port of VOLTA-TPU for NVIDIA Hopper.

It serves and fine-tunes ctrl_uniter on every task type of the JAX
package (VQA, NLVR2, retrieval, referring expressions, ...; ``python -m
volta_tpu_torch.eval_task``, ``python -m volta_tpu_torch.train_task``)
through hand-written CUDA kernels, held against the JAX package
``volta_tpu``. It imports nothing of that package: the config (``config``)
and the data layer (``data``) are its own copies. Importing it imports
no JAX and builds no kernel.
"""

from .config import SublayerSpec, VoltaConfig
from .models import VoltaForVLTasks, VoltaModel

__version__ = "0.1.0"

__all__ = ["VoltaConfig", "SublayerSpec", "VoltaModel", "VoltaForVLTasks"]
