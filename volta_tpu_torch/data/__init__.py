"""The port's data layer for the VQA slice: tokenizers, the LMDB region
feature reader, the packed feature store, the batch loader and the QA
datasets. Copies of the ``volta_tpu/data`` modules of the same names, which
use numpy and the standard library only."""
