"""The port's data layer: tokenizers, the LMDB region feature reader, the
packed feature store, the batch loader and the task datasets. Copies of the ``volta_tpu/data`` modules of the same names, which
use numpy and the standard library only."""
