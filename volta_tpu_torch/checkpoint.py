"""Checkpoint I/O: reference-format torch checkpoints in and out, and the
port's own train state.

Counterpart of ``volta_tpu/checkpoint.py`` (which imports JAX):

  * VOLTA-format ``.bin`` state dicts (the published checkpoints) and HF
    BERT ones, whose layers map onto VOLTA sublayers through
    ``bert_layer2attn_sublayer`` / ``bert_layer2ff_sublayer``
    (reference: volta/utils.py:461-498), with the ``module.`` prefix, the
    ``gamma``/``beta`` renames and the token-type resize
    (reference: train_concap.py:188-195): ``import_state_dict``,
    ``from_pretrained``;
  * the reverse, a state dict the reference models load with
    ``strict=True``: ``export_reference_state_dict``,
    ``save_reference_checkpoint``;
  * a mid-run resume from the reference's ``pytorch_ckpt_latest.tar``
    (reference: volta/train_utils.py:295-340): weights, AdamW moments
    mapped by name, ``global_step``: ``resume_from_reference_tar``, and its
    writer ``save_reference_tar``;
  * the port's own ``train_state.pt`` (model, optimizer, dropout-seed
    generator, step): ``save_train_state``, ``restore_train_state``.

The port's parameter names are the Flax paths joined by dots, with
``weight`` for a Dense kernel, a LayerNorm scale and an Embed table
(``bert.encoder.attn_0.query.weight``), so the JAX package's name tables
apply to the Flax path of each parameter, and its reports name the same
Flax paths. Reference tensors are already in torch's layout: nothing is
transposed, the moments neither. The JAX package's own saves (Flax msgpack
bundles, Orbax directories) are not read here (``convert.py`` bridges Flax
params).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import VoltaConfig
from .parallel import is_rank0

logger = logging.getLogger(__name__)

TRAIN_STATE = "train_state.pt"

# ------------------------------------------------------- name derivation
# copies of volta_tpu/checkpoint.py:47-138
_EMB_MAP_COMMON = {
    "word_embeddings": ("word_embeddings", "embed"),
    "position_embeddings": ("position_embeddings", "embed"),
    "token_type_embeddings": ("token_type_embeddings", "embed"),
    "layer_norm": ("LayerNorm", "ln"),
}

_EMB_MAP_BY_VARIANT = {
    "uniter": {
        "feat_dense": ("image_embeddings", "dense"),
        "loc_dense": ("image_location_embeddings", "dense"),
        "feat_ln": ("image_layer_norm", "ln"),
        "loc_ln": ("image_location_layer_norm", "ln"),
        "v_layer_norm": ("v_LayerNorm", "ln"),
    },
    "visualbert": {
        "projection": ("projection", "dense"),
        "token_type_embeddings_visual": ("token_type_embeddings_visual",
                                         "embed"),
        "position_embeddings_visual": ("position_embeddings_visual", "embed"),
    },
    "vl-bert": {
        "obj_downsample": ("obj_downsample.1", "dense"),
        "object_linguistic_embeddings": ("object_linguistic_embeddings",
                                         "embed"),
        "object_mask_word_embedding": ("object_mask_word_embedding",
                                       "param2d"),
        "object_mask_visual_embedding": ("object_mask_visual_embedding",
                                         "param2d"),
        "end_embedding": ("end_embedding", "embed"),
        "visual_1x1_text": ("visual_1x1_text", "dense"),
        "visual_1x1_object": ("visual_1x1_object", "dense"),
        "visual_ln_text": ("visual_ln_text", "ln"),
        "visual_ln_object": ("visual_ln_object", "ln"),
    },
    # dual-stream v_embeddings
    "vilbert_v": {
        "feat_dense": ("image_embeddings", "dense"),
        "loc_dense": ("image_location_embeddings", "dense"),
        "layer_norm": ("LayerNorm", "ln"),
    },
    "lxmert_v": {
        "feat_dense": ("image_embeddings", "dense"),
        "loc_dense": ("image_location_embeddings", "dense"),
        "feat_ln": ("ImgLayerNorm", "ln"),
        "loc_ln": ("LocLayerNorm", "ln"),
    },
}

_ATTN_MAP = {
    "query": ("attention_self.query", "dense"),
    "key": ("attention_self.key", "dense"),
    "value": ("attention_self.value", "dense"),
    "v_query": ("attention_self.v_query", "dense"),
    "v_key": ("attention_self.v_key", "dense"),
    "v_value": ("attention_self.v_value", "dense"),
    "out_dense": ("attention_output.dense", "dense"),
    "out_ln": ("attention_output.LayerNorm", "ln"),
    "v_out_dense": ("attention_output.v_dense", "dense"),
    "v_out_ln": ("attention_output.v_LayerNorm", "ln"),
}

_FF_MAP = {
    "inter_dense": ("intermediate.dense", "dense"),
    "v_inter_dense": ("intermediate.v_dense", "dense"),
    "out_dense": ("output.dense", "dense"),
    "out_ln": ("output.LayerNorm", "ln"),
    "v_out_dense": ("output.v_dense", "dense"),
    "v_out_ln": ("output.v_LayerNorm", "ln"),
}

# HF BERT uses these inside encoder.layer.{i}.
_HF_ATTN_MAP = {
    "query": ("attention.self.query", "dense"),
    "key": ("attention.self.key", "dense"),
    "value": ("attention.self.value", "dense"),
    "out_dense": ("attention.output.dense", "dense"),
    "out_ln": ("attention.output.LayerNorm", "ln"),
}

_HF_FF_MAP = {
    "inter_dense": ("intermediate.dense", "dense"),
    "out_dense": ("output.dense", "dense"),
    "out_ln": ("output.LayerNorm", "ln"),
}

_CLS_MAP = {
    ("predictions", "transform_dense"): ("cls.predictions.transform.dense",
                                         "dense"),
    ("predictions", "transform_ln"): ("cls.predictions.transform.LayerNorm",
                                      "ln"),
    ("predictions", "decoder_bias"): ("cls.predictions.bias", "raw"),
    ("image_predictions", "transform_dense"):
        ("cls.imagePredictions.transform.dense", "dense"),
    ("image_predictions", "transform_ln"):
        ("cls.imagePredictions.transform.LayerNorm", "ln"),
    ("bi_seq_relationship",): ("cls.bi_seq_relationship", "dense"),
}

# share_layer makes the reference register one torch module under two names
# (reference: volta/encoders.py:208-217 attention, :473-478/:527-532 FF), so
# its state dict carries v_* alias keys (volta_tpu/checkpoint.py:322-333)
_ATTN_ALIASES = (
    ("attention_self.query", "attention_self.v_query"),
    ("attention_self.key", "attention_self.v_key"),
    ("attention_self.value", "attention_self.v_value"),
    ("attention_output.dense", "attention_output.v_dense"),
    ("attention_output.LayerNorm", "attention_output.v_LayerNorm"),
)
_FF_ALIASES = (
    ("intermediate.dense", "intermediate.v_dense"),
    ("output.dense", "output.v_dense"),
    ("output.LayerNorm", "output.v_LayerNorm"),
)

_NO_DECAY_REF = ("bias", "LayerNorm.bias", "LayerNorm.weight")


def ref_key(path: Tuple[str, ...], cfg: VoltaConfig, from_hf: bool
            ) -> Optional[Tuple[str, str]]:
    """Map a Flax parameter path (with its leaf) to (reference key
    prefix, kind), VOLTA naming or, with ``from_hf``, HF BERT naming; None
    where the reference has no such parameter. A backbone key keeps its
    ``bert.`` prefix; the callers also try it without
    (volta_tpu/checkpoint.py:141-221)."""
    if path[0] == "bert":
        path = path[1:]
        prefix = "bert."
    else:
        prefix = ""

    if path[0] == "embeddings":
        m = dict(_EMB_MAP_COMMON)
        m.update(_EMB_MAP_BY_VARIANT.get(cfg.image_embeddings, {}))
        if path[1] in m:
            name, kind = m[path[1]]
            return prefix + "embeddings." + name, kind
        return None
    if path[0] == "v_embeddings":
        m = _EMB_MAP_BY_VARIANT.get(cfg.image_embeddings + "_v", {})
        if path[1] in m:
            name, kind = m[path[1]]
            return prefix + "v_embeddings." + name, kind
        return None
    if path[0] == "encoder":
        layer, sub = path[1], path[2]  # attn_{n} | ff_{n}
        attn = layer.startswith("attn_")
        n = int(layer.split("_")[1])
        if from_hf:
            table = cfg.bert_layer2attn_sublayer if attn \
                else cfg.bert_layer2ff_sublayer
            inv = {int(v): int(k) for k, v in table.items()}
            hf_map = _HF_ATTN_MAP if attn else _HF_FF_MAP
            if n not in inv or sub not in hf_map:
                return None  # vision params never come from HF BERT
            name, kind = hf_map[sub]
            return prefix + f"encoder.layer.{inv[n]}." + name, kind
        kind_map = _ATTN_MAP if attn else _FF_MAP
        if sub not in kind_map:
            return None
        name, kind = kind_map[sub]
        return prefix + f"encoder.layer.{n}." + name, kind
    if path[0] in ("t_pooler", "v_pooler"):
        if from_hf:
            return None  # sizes differ; keep init
        return prefix + path[0] + ".dense", "dense"
    if path[0] == "cls":
        if path[1] == "image_predictions" and path[2].startswith("decoder_"):
            ix = path[2].split("_")[1]
            return f"cls.imagePredictions.decoder_dict.{ix}", "dense"
        for k, v in _CLS_MAP.items():
            if tuple(path[1:1 + len(k)]) == k:
                return v
        return None
    if path[0].startswith("clf_"):
        base = f"clfs_dict.{path[0][len('clf_'):]}"
        if len(path) == 2:  # a bare Dense classifier: ("clf_X", leaf)
            return base, "dense"
        # SimpleClassifier's Sequential is "logit_fc" (reference:
        # volta/encoders.py:787-814); the 2-layer V-logit head is an
        # anonymous Sequential (:1141-1147), tried by the callers
        m = {"dense1": (".logit_fc.0", "dense"), "ln": (".logit_fc.2", "ln"),
             "dense2": (".logit_fc.3", "dense")}
        if path[1] in m:
            name, kind = m[path[1]]
            return base + name, kind
        return None
    return None


def _ref_leaf(key: str, kind: str, leaf: str) -> str:
    """The state-dict key of Flax leaf ``leaf`` under reference prefix
    ``key``."""
    if kind in ("dense", "ln"):
        return key + (".bias" if leaf == "bias" else ".weight")
    if kind in ("embed", "param2d"):
        return key + ".weight"
    return key  # raw


def flax_paths(model: nn.Module) -> List[Tuple[Tuple[str, ...], str,
                                                torch.Tensor]]:
    """(Flax path with its leaf, port name, parameter) of every parameter
    of ``model``, in the order JAX flattens the Flax tree (sorted paths)."""
    from .optimization import _flax_leaf

    out = []
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            names = tuple(mname.split(".")) if mname else ()
            out.append((names + (_flax_leaf(module, pname),),
                        f"{mname}.{pname}" if mname else pname, p))
    return sorted(out, key=lambda e: e[0])


# ---------------------------------------------------------------- import
def _overlay(cfg: VoltaConfig, targets, sd: Dict[str, torch.Tensor], *,
             from_hf: bool, strict: bool):
    """The values ``sd`` gives ``targets`` [(Flax path, template tensor)]:
    a list of tensors of each template's dtype (None where the template
    stays) and the report of volta_tpu/checkpoint.py:247-314."""
    has_bert_keys = any(k.startswith("bert.") for k in sd)
    values, loaded, skipped, used = [], [], [], set()
    for names, tmpl in targets:
        dotted = ".".join(names)
        ref = ref_key(names, cfg, from_hf)
        val = None
        if ref is not None:
            key, kind = ref
            candidates = [key]
            if ".logit_fc." in key:
                # 2-layer V-logit heads use an unnamed Sequential
                candidates.append(key.replace(".logit_fc.", "."))
            if key.startswith("bert.") and not has_bert_keys:
                candidates.append(key[len("bert."):])
            elif not key.startswith("bert.") and has_bert_keys:
                candidates.insert(0, "bert." + key)
            for cand in candidates:
                full = _ref_leaf(cand, kind, names[-1])
                if full in sd:
                    used.add(full)
                    val = sd[full]
                    break
        if val is None:
            skipped.append(dotted)
            values.append(None)
            continue
        val = torch.as_tensor(val).to(tmpl.dtype)
        if val.shape != tmpl.shape:
            if ("token_type_embeddings" in names
                    and val.shape[0] < tmpl.shape[0]
                    and val.shape[1:] == tmpl.shape[1:]):
                # token-type resize: the leading rows
                # (reference: train_concap.py:188-195)
                grown = tmpl.detach().cpu().clone()
                grown[: val.shape[0]] = val
                val = grown
            elif strict:
                raise ValueError(f"shape mismatch for {dotted}: "
                                 f"{tuple(val.shape)} vs {tuple(tmpl.shape)}")
            else:
                skipped.append(dotted + " (shape)")
                values.append(None)
                continue
        loaded.append(dotted)
        values.append(val)
    report = {"loaded": loaded, "skipped": skipped,
              "unused": sorted(set(sd) - used)}
    if strict and report["skipped"]:
        raise ValueError(f"missing keys: {report['skipped']}")
    return values, report


def import_state_dict(cfg: VoltaConfig, model: nn.Module,
                      sd: Dict[str, Any], *, from_hf: bool = False,
                      strict: bool = False) -> Dict[str, List[str]]:
    """Load a reference-format state dict (VOLTA or, with ``from_hf``, HF
    BERT naming) into ``model``'s parameters in place. Returns the report
    JAX's ``import_state_dict`` gives for the same dict: the Flax paths
    loaded and skipped (kept at their values; " (shape)" where the shapes
    differ), and the keys of ``sd`` that nothing read. ``strict`` raises on
    a skipped parameter or a shape that differs, before anything is
    written."""
    entries = flax_paths(model)
    values, report = _overlay(cfg, [(n, p) for n, _, p in entries], sd,
                              from_hf=from_hf, strict=strict)
    with torch.no_grad():
        for (_, _, p), val in zip(entries, values):
            if val is not None:
                p.copy_(val)
    return report


def _normalize_keys(raw: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The DDP ``module.`` prefix stripped, ``gamma``/``beta`` renamed to
    ``weight``/``bias``, values as CPU tensors
    (volta_tpu/checkpoint.py:487-496)."""
    out = {}
    for k, v in raw.items():
        k = re.sub(r"^module\.", "", k)
        k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
    return out


def _tolerant_torch_load(path: str):
    """``torch.load`` that survives unknown classes: the reference's
    ``pytorch_ckpt_latest.tar`` embeds its live ``tbLogger`` object
    (volta/train_utils.py:305-317), whose class exists only where the
    reference package imports; such objects load as opaque stubs."""
    import pickle

    class _Opaque:
        def __init__(self, *a, **k):
            pass

        def __setstate__(self, state):
            self.__dict__["_opaque_state"] = state

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except Exception:  # noqa: BLE001 - any unimportable class
                return _Opaque

    shim = type("pickle_shim", (), {"Unpickler": _Unpickler,
                                    "load": staticmethod(pickle.load)})
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=shim)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.bin`` / ``.tar`` checkpoint's state dict, unwrapped from
    ``model_state_dict`` or ``state_dict``, keys normalised."""
    obj = _tolerant_torch_load(path)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return _normalize_keys(obj)


# ---------------------------------------------------------------- export
def _export(cfg: VoltaConfig, entries) -> Tuple[Dict[str, torch.Tensor],
                                                 List[str]]:
    """Reference keys for [(Flax path, tensor)]: the inverse of
    ``_overlay``'s mapping, the anonymous-Sequential heads by their missing
    LN; returns (state dict, unmapped paths)."""
    clf_leaves: Dict[str, set] = {}
    for names, _ in entries:
        if names[0].startswith("clf_") and len(names) == 3:
            clf_leaves.setdefault(names[0], set()).add(names[1])
    sd, unexported = {}, []
    for names, val in entries:
        ref = ref_key(names, cfg, from_hf=False)
        if ref is None:
            unexported.append(".".join(names))
            continue
        key, kind = ref
        if ".logit_fc." in key and "ln" not in clf_leaves.get(names[0], ()):
            key = key.replace(".logit_fc.", ".")  # anonymous Sequential head
        val = val.detach().cpu()
        if val.is_floating_point():
            val = val.float()
        sd[_ref_leaf(key, kind, names[-1])] = val.contiguous()
    return sd, unexported


def _add_aliases(cfg: VoltaConfig, sd: Dict[str, torch.Tensor]):
    """The tied MLM decoder and the shared sublayers' ``v_*`` keys, the
    same tensors under their second names (volta_tpu/checkpoint.py:399-413)."""
    if "cls.predictions.bias" in sd:
        table = [k for k in sd
                 if k.endswith("embeddings.word_embeddings.weight")]
        if table:
            sd["cls.predictions.decoder.weight"] = sd[table[-1]]
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    for spec in cfg.sublayer_plan():
        if not spec.share_params:
            continue
        aliases = _ATTN_ALIASES if spec.kind == "attn" else _FF_ALIASES
        base = f"{prefix}encoder.layer.{spec.index}."
        for src, dst in aliases:
            for leaf in (".weight", ".bias"):
                if base + src + leaf in sd:
                    sd[base + dst + leaf] = sd[base + src + leaf]


def export_reference_state_dict(cfg: VoltaConfig, model: nn.Module
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, List[str]]]:
    """The inverse of ``import_state_dict``: a reference-format state dict
    of ``model``'s parameters (float32, on the CPU) that the reference
    models load with ``strict=True``, key for key the JAX package's
    ``export_torch_state_dict`` of the same weights, with the tied MLM
    decoder and the ``v_*`` alias keys of shared sublayers. Returns
    ``(state_dict, {"unexported": [...]})``, the paths with no reference
    name (expected empty)."""
    sd, unexported = _export(cfg, [(n, p) for n, _, p in flax_paths(model)])
    _add_aliases(cfg, sd)
    return sd, {"unexported": unexported}


def save_reference_checkpoint(path: str, cfg: VoltaConfig,
                              model: nn.Module) -> str:
    """``torch.save`` ``export_reference_state_dict`` as a ``.bin`` the
    reference loads (its save format: volta/train_utils.py:295-303). In a
    process group only rank 0 writes; every rank returns the path."""
    if not is_rank0():
        return path
    sd, report = export_reference_state_dict(cfg, model)
    if report["unexported"]:
        logger.warning("paths without a reference name: %s",
                       report["unexported"])
    torch.save(sd, path)
    return path


# ------------------------------------- mid-run resume from a reference tar
def _alias_key_set(cfg: VoltaConfig, sd: Dict[str, Any]) -> set:
    """State-dict keys that are second names of a shared tensor, which
    ``named_parameters()`` (the reference optimizer's grouping loop)
    leaves out: the tied MLM decoder and the ``v_*`` aliases."""
    keys = set()
    if "cls.predictions.decoder.weight" in sd:
        keys.add("cls.predictions.decoder.weight")
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    for spec in cfg.sublayer_plan():
        if not spec.share_params:
            continue
        aliases = _ATTN_ALIASES if spec.kind == "attn" else _FF_ALIASES
        base = f"{prefix}encoder.layer.{spec.index}."
        for _, dst in aliases:
            for leaf in (".weight", ".bias"):
                if base + dst + leaf in sd:
                    keys.add(base + dst + leaf)
    return keys


def _optimizer_index_to_name(cfg: VoltaConfig, msd: Dict[str, Any],
                             param_groups) -> Dict[int, str]:
    """Which state-dict key each torch optimizer-state index stands for
    (volta_tpu/checkpoint.py:499-532): torch numbers the parameters of its
    groups in turn; the groups were built from ``named_parameters()``,
    whose order is the state dict's without the aliases, less the frozen
    ``fixed_layers``, and grouped
      * one parameter a group (train_task.py:208-218): that order;
      * two groups (train_concap.py:204-210): the decayed parameters, then
        the others, each in that order."""
    named = [k for k in msd if k not in _alias_key_set(cfg, msd)]
    fixed = tuple(getattr(cfg, "fixed_layers", None) or ())
    if fixed:
        named = [k for k in named if not any(f in k for f in fixed)]
    if param_groups and all(len(g["params"]) == 1 for g in param_groups):
        order = named
    elif len(param_groups) == 2:
        nd = lambda k: any(s in k for s in _NO_DECAY_REF)  # noqa: E731
        order = [k for k in named if not nd(k)] + [k for k in named if nd(k)]
    else:
        raise ValueError(
            f"unrecognized param_groups layout ({len(param_groups)} groups "
            f"with sizes {[len(g['params']) for g in param_groups]})")
    flat_idx = [i for g in param_groups for i in g["params"]]
    if len(flat_idx) != len(order):
        raise ValueError(
            f"optimizer indexes {len(flat_idx)} params but the state dict "
            f"implies {len(order)} trainable params — fixed_layers or "
            f"grouping mismatch")
    return dict(zip(flat_idx, order))


def _resume_tar(cfg: VoltaConfig, state, obj, path: str) -> Dict[str, Any]:
    if not isinstance(obj, dict) or "model_state_dict" not in obj:
        raise ValueError(f"{path} has no model_state_dict: not a reference "
                         "checkpoint tar")
    msd = _normalize_keys(obj["model_state_dict"])
    report = import_state_dict(cfg, state.model, msd)
    if report["skipped"]:
        logger.warning("tar resume: %d params kept their current values: "
                       "%s...", len(report["skipped"]), report["skipped"][:5])
    osd = obj.get("optimizer_state_dict") or {}
    entries = osd.get("state") or {}
    info = {"global_step": int(obj.get("global_step", 0)),
            "epoch_id": int(obj.get("epoch_id", -1)),
            "score": obj.get("score"), "hyperparams": {}}
    opt = state.optimizer
    opt_state = opt.state_dict()
    if entries:
        idx2name = _optimizer_index_to_name(cfg, msd,
                                            osd.get("param_groups", []))
        mu_sd, nu_sd, steps = {}, {}, [0]
        for i, entry in entries.items():
            name = idx2name[int(i)]
            mu_sd[name] = torch.as_tensor(entry["exp_avg"])
            nu_sd[name] = torch.as_tensor(entry["exp_avg_sq"])
            if "step" in entry:
                steps.append(int(entry["step"]))
        entries = flax_paths(state.model)
        targets = [(n, torch.zeros_like(p, device="cpu"))
                   for n, _, p in entries]
        for key, moments in (("mu", mu_sd), ("nu", nu_sd)):
            values, rep = _overlay(cfg, targets, moments, from_hf=False,
                                   strict=False)
            if rep["unused"]:
                raise ValueError(f"optimizer moments with no parameter "
                                 f"mapping: {rep['unused'][:5]}")
            # a parameter the tar has no moments for starts from zeros
            opt_state[key] = {name: tmpl if val is None else val
                              for (_, name, _), (_, tmpl), val
                              in zip(entries, targets, values)}
        opt_state["adam_count"] = max(steps)
        g0 = (osd.get("param_groups") or [{}])[0]
        info["hyperparams"] = {k: g0[k] for k in
                               ("lr", "betas", "eps", "weight_decay",
                                "correct_bias") if k in g0}
    # the schedule's position follows global_step, bias correction the
    # moments' own step (volta_tpu/checkpoint.py:535-560)
    opt_state["count"] = info["global_step"]
    opt.load_state_dict(opt_state)
    state.step = info["global_step"]
    return info


def resume_from_reference_tar(cfg: VoltaConfig, state, path: str
                              ) -> Dict[str, Any]:
    """Resume the train state ``state`` (``train_step.TrainState``) in
    place from the reference's ``pytorch_ckpt_latest.tar``: the weights
    through ``import_state_dict``, the AdamW or RAdam moments by name (cast
    to the optimizer's stored dtype), the schedule's count and
    ``state.step`` from ``global_step``, bias correction's (or RAdam's)
    count from the moments' largest ``step``
    (volta_tpu/checkpoint.py:535-575). The tar holds no dropout generator:
    ``state.generator`` stays as it is. Returns ``{global_step, epoch_id,
    score, hyperparams}``, the latter the tar's first group's (they do not
    configure the run)."""
    return _resume_tar(cfg, state, _tolerant_torch_load(path), path)


def save_reference_tar(path: str, cfg: VoltaConfig, state, epoch_id: int,
                       score: Optional[float] = None) -> str:
    """Write ``state`` as the reference's ``pytorch_ckpt_latest.tar``
    (volta/train_utils.py:305-317): the exported weights, the AdamW or RAdam
    moments (float32) under torch's optimizer-state indices with one
    parameter a group (as its train_task.py:208-218 groups them),
    ``global_step`` and ``epoch_id``. In a process group only rank 0
    writes; every rank returns the path."""
    if not is_rank0():
        return path
    opt = state.optimizer
    entries = flax_paths(state.model)
    msd, _ = _export(cfg, [(n, p) for n, _, p in entries])
    _add_aliases(cfg, msd)
    named = [k for k in msd if k not in _alias_key_set(cfg, msd)]
    ostate = opt.state_dict()
    # float32, as torch's optimizers hold them, whatever the stored dtype
    moments = {key: _export(cfg, [(n, ostate[key][name].float())
                                  for n, name, _ in entries])[0]
               for key in ("mu", "nu")}
    decayed = {opt.names[i] for i in opt.decayed}
    ref_decayed = _export(cfg, [(n, torch.tensor(float(name in decayed)))
                                for n, name, _ in entries])[0]
    groups, states = [], {}
    for i, key in enumerate(named):
        states[i] = {"step": opt.adam_count, "exp_avg": moments["mu"][key],
                     "exp_avg_sq": moments["nu"][key]}
        groups.append({"lr": opt.lr(), "betas": (opt.b1, opt.b2),
                       "eps": opt.eps, "correct_bias": opt.correct_bias,
                       "weight_decay": opt.weight_decay
                       if float(ref_decayed[key]) else 0.0, "params": [i]})
    torch.save({"model_state_dict": msd,
                "optimizer_state_dict": {"state": states,
                                         "param_groups": groups},
                "global_step": state.step, "epoch_id": epoch_id,
                "score": score}, path)
    return path


# ---------------------------------------------- the port's own train state
def save_train_state(path: str, state, epoch: int, best_score: float) -> str:
    """``torch.save`` the model, the optimizer, the dropout-seed generator
    and the step to ``<path>/train_state.pt``. In a process group only
    rank 0 writes (the ranks hold the same state); every rank returns the
    path."""
    out = os.path.join(path, TRAIN_STATE)
    if not is_rank0():
        return out
    os.makedirs(path, exist_ok=True)
    torch.save({"step": state.step, "epoch": epoch, "best_score": best_score,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "generator": state.generator.get_state()}, out)
    return out


def _train_state_path(path: str) -> str:
    return os.path.join(path, TRAIN_STATE) if os.path.isdir(path) else path


def _is_train_state(obj) -> bool:
    return isinstance(obj, dict) and isinstance(obj.get("model"), dict) \
        and "optimizer" in obj and "generator" in obj


def _restore(state, obj) -> Dict[str, Any]:
    state.model.load_state_dict(obj["model"], strict=True)
    state.optimizer.load_state_dict(obj["optimizer"])
    state.generator.set_state(obj["generator"])
    state.step = int(obj["step"])
    return {"step": state.step, "epoch": int(obj["epoch"]),
            "best_score": float(obj["best_score"])}


def restore_train_state(path: str, state) -> Dict[str, Any]:
    """Restore ``state`` in place from a ``save_train_state`` file (or the
    directory holding it): model, optimizer, generator, step. Returns
    ``{step, epoch, best_score}``."""
    return _restore(state, torch.load(_train_state_path(path),
                                      map_location="cpu", weights_only=True))


def resume(cfg: VoltaConfig, state, path: str, steps_per_epoch: int,
           micro_steps_per_epoch: int) -> Dict[str, Any]:
    """Resume ``state`` from a reference tar or from the port's own train
    state (file or directory), as the JAX CLI does (train_task.py:197-212):
    returns ``{start_epoch, global_step, best_score}`` and, for a tar, its
    ``hyperparams``. A tar's epoch is its ``epoch_id`` + 1, or its
    ``global_step`` (updates) over the epoch's updates; the port's, its
    step (micro-steps under gradient accumulation) over the epoch's
    micro-steps, ``micro_steps_per_epoch`` (the loader's batches).
    JAX's CLI divides its micro-steps by the epoch's updates there
    (train_task.py:182,227), which skips epochs with K > 1."""
    path = _train_state_path(path)
    obj = _tolerant_torch_load(path)
    if _is_train_state(obj):
        info = _restore(state, obj)
        return {"start_epoch": info["step"] // max(micro_steps_per_epoch, 1),
                "global_step": info["step"],
                "best_score": info["best_score"], "hyperparams": {}}
    info = _resume_tar(cfg, state, obj, path)
    start = info["epoch_id"] + 1 if info["epoch_id"] >= 0 \
        else info["global_step"] // max(steps_per_epoch, 1)
    return {"start_epoch": start, "global_step": info["global_step"],
            "best_score": -1.0, "hyperparams": info["hyperparams"]}


# --------------------------------------------------------------- pretrained
def cached_path(url_or_filename: str,
                cache_dir: Optional[str] = None) -> str:
    """A local path or ``file://`` URL, checked; an http(s) or s3 URL as
    the file placed in the cache (``cache_dir``, default
    ``~/.cache/volta_tpu_torch``, named by the URL's sha256 as in
    volta_tpu/checkpoint.py:649-714). The port downloads nothing: an
    uncached URL raises and names the path where the file belongs."""
    import hashlib
    from urllib.parse import urlparse

    parsed = urlparse(url_or_filename)
    if parsed.scheme in ("", "file"):
        path = parsed.path if parsed.scheme == "file" else url_or_filename
        if not os.path.exists(path):
            raise FileNotFoundError(f"file {path} not found")
        return path
    if parsed.scheme not in ("http", "https", "s3"):
        raise ValueError(
            f"unable to parse {url_or_filename} as a URL or local path")
    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".cache",
                                          "volta_tpu_torch")
    cache_path = os.path.join(
        cache_dir, hashlib.sha256(url_or_filename.encode()).hexdigest())
    if not os.path.exists(cache_path):
        raise FileNotFoundError(
            f"{url_or_filename} is not cached and the port downloads "
            f"nothing: place the file at {cache_path}")
    return cache_path


def _is_port_state_dict(sd: Dict[str, Any]) -> bool:
    """The port's own names: sublayers ``encoder.attn_N`` / ``ff_N``, where
    the reference has ``encoder.layer.N``."""
    return any(re.search(r"(^|\.)encoder\.(attn|ff)_\d+\.", k) for k in sd)


def _load_port_state_dict(model: nn.Module, obj: Dict[str, Any]
                          ) -> Dict[str, Any]:
    """The port's own state dict into ``model``, by top-level module
    (``bert``, ``cls``, ``clf_TASK1``, ...), as the JAX package overlays an
    Orbax tree (volta_tpu/checkpoint.py:788-805): every module both have is
    loaded whole, strictly (a key missing from or extra to a module the
    dict has raises torch's error, and so does a dict without ``bert``);
    the model's other modules keep their values (``skipped``) and the
    dict's other modules are ``unused``. So a pretraining checkpoint gives
    a task model its trunk and leaves out the ``cls`` heads, and the other
    way round."""
    top = lambda k: k.split(".", 1)[0]  # noqa: E731
    own = model.state_dict()
    shared = {top(k) for k in own} & {top(k) for k in obj}
    sub = {k: v for k, v in obj.items() if top(k) in shared}
    if "bert" not in shared or {k for k in own if top(k) in shared} \
            != set(sub):
        model.load_state_dict(obj, strict=True)  # raises, naming the keys
    model.load_state_dict(sub, strict=False)
    return {"loaded": list(sub),
            "skipped": [k for k in own if top(k) not in shared],
            "unused": [k for k in obj if top(k) not in shared]}


def from_pretrained(cfg: VoltaConfig, model: nn.Module, path: str, *,
                    from_hf: bool = False,
                    cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """Load pretrained weights into ``model`` in place; the format is
    detected:
      * the port's own state dict (``torch.save(model.state_dict())``) or
        train state (``train_state.pt`` or the directory holding it),
        module by module (``_load_port_state_dict``: a pretraining model's
        into a task model loads the trunk and leaves out the heads);
      * a reference-format ``.bin`` (or a reference tar's weights), VOLTA
        naming, or HF BERT naming where its layers are named
        ``*.attention.self.query.*`` (or with ``from_hf``), through
        ``import_state_dict``;
      * an http(s)/s3 URL of one, through ``cached_path``.
    A Flax msgpack bundle or an Orbax directory (the JAX package's own
    saves) raises. Returns the report:
    ``loaded`` / ``skipped`` / ``unused``."""
    if "://" in path:
        path = cached_path(path, cache_dir)
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, TRAIN_STATE)):
            raise NotImplementedError(
                f"{path} is a directory without {TRAIN_STATE}: the JAX "
                "package's Flax msgpack bundles and Orbax checkpoints are "
                "not read by the port (ROADMAP.md Queue 1 item 12; "
                "volta_tpu_torch.convert bridges Flax params)")
        path = os.path.join(path, TRAIN_STATE)
    obj = _tolerant_torch_load(path)
    if _is_train_state(obj):
        obj = obj["model"]
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if _is_port_state_dict(obj):
        return _load_port_state_dict(model, obj)
    sd = _normalize_keys(obj)
    if not from_hf:
        # HF BERT checkpoints by their layer naming
        from_hf = any(".attention.self.query." in k for k in sd)
    return import_state_dict(cfg, model, sd, from_hf=from_hf)
