"""Weight bridge from the JAX package's Flax parameter tree to the port.

The port's submodules carry the Flax tree's names, so the bridge is a
generic walk: ``a/b/c/kernel`` becomes ``a.b.c.weight`` transposed (Flax
keeps Dense kernels as [in, out], torch as [out, in]), LayerNorm ``scale``
and Embed ``embedding`` become ``weight``, ``bias`` stays ``bias``, and a
module's raw parameters (VL-BERT's mask embeddings) keep their names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias",
         # the tied MLM decoder's own bias
         "decoder_bias": "decoder_bias",
         # VL-BERT's raw parameters keep their names
         "object_mask_visual_embedding": "object_mask_visual_embedding",
         "object_mask_word_embedding": "object_mask_word_embedding"}


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (a nested dict of arrays, with or without the outer
    ``{"params": ...}``) -> the port's state dict. Raises on a leaf name
    it does not know."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}

    def walk(tree, prefix):
        for name, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (name,))
                continue
            if name not in _LEAF:
                raise KeyError(f"no torch counterpart for Flax leaf "
                               f"{'/'.join(prefix + (name,))}")
            arr = np.array(val, dtype=np.float32)
            if name == "kernel":
                arr = arr.T
            out[".".join(prefix + (_LEAF[name],))] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(params, ())
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load Flax params into ``model`` with ``strict=True``: a leaf left
    over on either side, or a shape that differs, raises."""
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model
