"""Serving export: saved programs of the eval forward, ``torch.export``.

Counterpart of ``volta_tpu/export.py``: the fine-tuned task forward is
staged out with ``torch.export`` into a file that a serving process loads
and calls without the Python model code. The program pins the sequence and
region lengths and the input dtypes; the batch is an int or, with a symbol
such as ``"b"``, a ``torch.export.Dim`` that serves any batch size. By
default the program is *parameterized*: it is called as ``(params,
*batch)`` and holds no weights (a weight refresh needs no export);
``bake_weights=True`` keeps the weights inside the file.

Two kinds of artifact, by ``cfg.use_pallas``:

- a kernel artifact (``use_pallas``): the eval forward's kernels are the
  ops that ``ops.library`` registers (``volta::attention_fwd``, ...), so
  the loaded program launches the same kernels as the live forward on the
  card (and runs their twins on CPU tensors). It names ``cuda`` as its
  platform; a loading process imports ``volta_tpu_torch.ops.library``,
  and nothing of ``volta_tpu_torch.models``.
- a portable artifact (``use_pallas: false``): aten ops only; a loading
  process needs plain ``torch``.

The program keeps the device it was traced on (its position ids and
masks are made there), so an artifact for the card is traced on the card
(the CLI's ``--device``).

Logits come out raw (no softmax), as ``VoltaForVLTasks.forward`` returns
them.
"""

from __future__ import annotations

import copy
import json
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils._pytree import tree_map

from .config import VoltaConfig

META = "volta_export.json"


def eval_arg_specs(cfg: VoltaConfig, batch_size: int, seq_len: int,
                   region_len: int):
    """(shape, dtype) of the task-forward inputs in call order (JAX's
    ``_eval_arg_shapes``, volta_tpu/export.py:34-52): input_ids,
    image_feat, image_loc, token_type_ids, attention_mask,
    image_attention_mask."""
    b, l, r = batch_size, seq_len, region_len
    i32, f32 = torch.int32, torch.float32
    return (((b, l), i32), ((b, r, cfg.v_feature_size), f32),
            ((b, r, cfg.num_locs), f32), ((b, l), i32), ((b, l), i32),
            ((b, r), i32))


def quantize_residual_dtype(cfg: VoltaConfig):
    """Shipping dtype for the non-quantized params of an int8 bundle:
    bf16 when that's the compute dtype, else None (left untouched)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


class _Baked(nn.Module):
    """``forward(*batch)``: the model's logits, its weights inside."""

    def __init__(self, model, task):
        super().__init__()
        self.model, self.task = model, task

    def forward(self, input_ids, image_feat, image_loc, token_type_ids,
                attention_mask, image_attention_mask):
        return self.model(input_ids, image_feat, image_loc, self.task,
                          token_type_ids, attention_mask,
                          image_attention_mask)


class _Parameterized(nn.Module):
    """``forward(params, *batch)``: the model's logits with ``params`` in
    place of its parameters (``torch.func.functional_call``), each cast to
    the parameter's own dtype (an int8 bundle ships bf16 residuals, which
    ``quantize_model`` copies into float32 parameters). With ``int8`` the
    params are the bundle and its entries are the ``Dense`` layers'
    ``int8`` for the call. The model is held outside the module's
    attributes, so its weights are not the program's."""

    def __init__(self, model, task, int8: bool):
        super().__init__()
        self._held = (model,)
        self.task, self.int8 = task, int8
        self.dtypes = {n: p.dtype for n, p in model.named_parameters()}

    def forward(self, params, input_ids, image_feat, image_loc,
                token_type_ids, attention_mask, image_attention_mask):
        from .ops.int8_dense import dense_modules

        (model,) = self._held
        denses, saved = {}, {}
        if self.int8:
            denses = dense_modules(model)
            saved = {k: m.int8 for k, m in denses.items()}
            for k, entry in params["int8"].items():
                denses[k].int8 = entry
            params = params["params"]
        try:
            return torch.func.functional_call(
                model, {n: v.to(self.dtypes[n]) for n, v in params.items()},
                (input_ids, image_feat, image_loc, self.task,
                 token_type_ids, attention_mask, image_attention_mask))
        finally:
            for k, entry in saved.items():
                denses[k].int8 = entry


class Exported:
    """A saved forward: ``program`` (the ``torch.export.ExportedProgram``),
    ``platforms``, and ``call(*args)`` (``(params, *batch)``, or ``*batch``
    for a baked program)."""

    def __init__(self, program, platforms: Sequence[str]):
        self.program = program
        self.platforms = tuple(platforms)
        self._module = None

    def call(self, *args):
        if self._module is None:
            self._module = self.program.module()
        return self._module(*args)


def _platforms(cfg: VoltaConfig, platforms, device: torch.device):
    """The artifact's platforms, by JAX's rule (volta_tpu/export.py
    :133-141) with ``cuda`` in place of ``tpu``."""
    if cfg.use_pallas:
        if platforms is None or set(platforms) - {"cuda"}:
            raise ValueError(
                "use_pallas artifacts hold the port's CUDA kernels as ops; "
                "export with platforms=('cuda',) or set cfg.use_pallas="
                "False for a portable artifact")
        return tuple(platforms)
    return tuple(platforms) if platforms else (device.type,)


def export_task_forward(cfg: VoltaConfig, task_cfg, task: str, params,
                        batch_size, seq_len: int, region_len: int,
                        platforms: Optional[Sequence[str]] = None,
                        bake_weights: bool = False,
                        quantize: Optional[str] = None, act_scales=None
                        ) -> Exported:
    """Stage the eval forward of ``task`` out to an ``Exported``
    (volta_tpu/export.py:62-147). ``params`` is the model's state dict
    (``model.state_dict()``, or ``convert.state_dict_from_flax`` of JAX's
    params); the program is traced on its device. ``region_len`` counts
    the global-image row where ``cfg.add_global_imgfeat`` adds one.
    ``batch_size`` is an int or a symbol (``"b"``) for a batch-polymorphic
    program; sequence and region lengths stay pinned. The model runs in
    eval mode under ``torch.no_grad()``.

    Parameterized (the default): ``.call(params, *batch)``, with the
    state dict, or with ``quantize`` the bundle of
    ``ops.int8_dense.quantize_variables``. ``bake_weights``:
    ``.call(*batch)``. ``quantize="int8"`` runs every ``Dense`` through
    K9 (per-token activation scales); ``"int8_static"`` with the static
    ``act_scales`` of ``calibrate_activation_scales``, and raises without
    them."""
    from .models import VoltaForVLTasks
    from .ops import library
    from .ops.int8_dense import quantize_model, quantize_variables

    if quantize not in (None, "int8", "int8_static"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    if quantize == "int8_static" and act_scales is None:
        raise ValueError("int8_static needs act_scales "
                         "(calibrate_activation_scales)")
    device = next(iter(params.values())).device
    platforms = _platforms(cfg, platforms, device)
    model = VoltaForVLTasks(cfg, task_cfg, (task,))
    model.load_state_dict(params)
    model.to(device).eval()
    call_params = params
    if quantize is not None:
        call_params = quantize_variables(
            model, residual_dtype=quantize_residual_dtype(cfg),
            act_scales=act_scales if quantize == "int8_static" else None)
        model = quantize_model(copy.deepcopy(model), call_params)

    if bake_weights:
        root, lead = _Baked(model, task), ()
    else:
        root = _Parameterized(model, task, quantize is not None)
        lead = (call_params,)
    batch = tuple(torch.zeros(shape, dtype=dt, device=device)
                  for shape, dt in eval_arg_specs(
                      cfg, 2 if isinstance(batch_size, str) else batch_size,
                      seq_len, region_len))
    dynamic = None
    if isinstance(batch_size, str):
        dim = torch.export.Dim(batch_size)
        dynamic = tuple(tree_map(lambda _: None, lead)) + tuple(
            {0: dim} for _ in batch)
    with torch.no_grad(), library.kernel_export(cfg.use_pallas):
        program = torch.export.export(root, lead + batch,
                                      dynamic_shapes=dynamic, strict=False)
    # the example inputs would be saved with the program: the weights of a
    # parameterized one
    program.example_inputs = None
    ops = {str(n.target) for n in program.graph.nodes
           if str(n.target).startswith("volta.")}
    if bool(ops) != bool(cfg.use_pallas):
        raise RuntimeError(f"a {'kernel' if cfg.use_pallas else 'portable'} "
                           f"artifact holds the registered ops {ops}")
    return Exported(program, platforms)


def save_exported(exported: Exported, path: str) -> None:
    torch.export.save(exported.program, path, extra_files={
        META: json.dumps({"platforms": list(exported.platforms)})})


def load_exported(path: str) -> Exported:
    """Load a saved forward (its ops registered first). Run it with
    ``.call(params, *batch)`` (parameterized) or ``.call(*batch)``
    (baked)."""
    from .ops import library  # noqa: F401 (registers the volta ops)

    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    return Exported(program, json.loads(extra[META])["platforms"])
