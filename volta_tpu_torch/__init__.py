"""volta_tpu_torch: the PyTorch and CUDA port of VOLTA-TPU for NVIDIA Hopper.

It pretrains every family of the JAX package on Conceptual Captions
(``python -m volta_tpu_torch.train_concap``), and serves and fine-tunes it
on every task type (VQA, NLVR2, retrieval, referring expressions, ...;
``python -m volta_tpu_torch.eval_task``, ``python -m
volta_tpu_torch.train_task``) through hand-written CUDA kernels, held against the JAX package
``volta_tpu``. It imports nothing of that package: the config (``config``)
and the data layer (``data``) are its own copies. Importing it imports
no JAX and builds no kernel; the models load on first use.
"""

from .config import SublayerSpec, VoltaConfig

_MODELS = ("VoltaModel", "VoltaForVLTasks", "VoltaForVLPreTraining")


def __getattr__(name):
    # the models load on first use, so that a serving process that imports
    # only ``ops.library`` (a loaded kernel artifact) loads no model code
    if name in _MODELS:
        from . import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = ["VoltaConfig", "SublayerSpec", "VoltaModel", "VoltaForVLTasks",
           "VoltaForVLPreTraining"]
