"""Text and vision embedding variants.

Counterpart of ``volta_tpu/models/embeddings.py``; the five vision schemes
pick the family (reference: volta/embeddings.py):

  * dual-stream: ``TextEmbeddings`` for the text beside ``vilbert`` (the
    two linears summed, one LN) or ``lxmert`` (each linear LN'd, then the
    average) for the regions (``DUAL_EMBEDDINGS``);
  * single-stream (``SHARED_EMBEDDINGS``): ``vl-bert`` (sinusoidal box
    geometry and the features through ``obj_downsample``, the joint
    position ids), ``visualbert`` (a projection and visual type and
    position tables) and ``uniter`` (feature and location linears, each
    LN'd).

Dtype flow, as in the JAX modules: embedding tables and their sums are
float32; a ``Dense`` runs in the compute dtype, except VL-BERT's
``obj_downsample``, a float32 Flax ``nn.Dense``; adding a float32 row to a
bf16 value promotes it to float32; every module casts its outputs to the
compute dtype last. In training mode each output gets dropout
(``hash_dropout``, one seed a site from ``DropoutSeeds``) where the JAX
module runs ``nn.Dropout``: at ``hidden_dropout_prob``, at
``v_hidden_dropout_prob`` for the dual-stream region embeddings, and at
``v_attention_probs_dropout_prob`` on VL-BERT's ``obj_downsample`` input.
Submodules carry the Flax names; VL-BERT's two raw parameters
(``object_mask_visual_embedding``, ``object_mask_word_embedding``) are
their own Flax leaves.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VoltaConfig
from .layers import Dense, Embed, LayerNorm, hash_dropout, site_seed


def compute_dtype(cfg: VoltaConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def _drop(module, x, rate, seeds):
    """``x`` after the site's dropout: the next seed of ``seeds`` in
    training mode at a positive ``rate``, else ``x``."""
    seed = site_seed(module, rate, seeds)
    return x if seed is None else hash_dropout(x, seed, rate)


def _row(table: Embed, i: int, shape):
    """Row ``i`` of ``table`` broadcast to ``shape`` + [features]: the
    lookup of ids that are all ``i``, whose gradient is one sum."""
    return table.weight[i].expand(*shape, table.weight.shape[1])


def _text_tables(module, cfg: VoltaConfig):
    std = cfg.initializer_range
    module.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, std,
                                   zero_pad_row=True)
    module.position_embeddings = Embed(cfg.max_position_embeddings,
                                       cfg.hidden_size, std)
    module.token_type_embeddings = Embed(cfg.type_vocab_size,
                                         cfg.hidden_size, std,
                                         fixed_order_grad=True)


def _text_sum(module, input_ids, token_type_ids, position_ids):
    """word + position + token type, float32; ``position_ids`` [L]."""
    return (module.word_embeddings(input_ids)
            + module.position_embeddings(position_ids)[None]
            + module.token_type_embeddings(token_type_ids))


# ===================================================================== text
class TextEmbeddings(nn.Module):
    """word + position + token type embeddings, LN, dropout, the cast
    (reference: volta/embeddings.py:39-70), the dual-stream families' text.
    With ``model: roberta`` and ``roberta_position_offset`` the positions
    start at 2, fairseq's padding_idx + 1 (volta_tpu/models/embeddings.py
    :47-55: opt-in, since the reference computes and then overwrites
    them)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        self.offset = 2 if (cfg.model == "roberta"
                            and cfg.roberta_position_offset) else 0
        _text_tables(self, cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    use_kernel=cfg.use_pallas_layernorm)

    def forward(self, input_ids, token_type_ids, seeds=None):
        seq = input_ids.shape[1]
        pos = torch.arange(self.offset, seq + self.offset,
                           device=input_ids.device)
        x = self.layer_norm(_text_sum(self, input_ids, token_type_ids, pos))
        return _drop(self, x, self.rate, seeds).to(self.dtype)


# ============================================================== dual-stream
class ViLBertImageEmbeddings(nn.Module):
    """feature linear + location linear, summed, one LN
    (reference: volta/embeddings.py:127-146), all in the compute dtype;
    initialised with ``v_initializer_range``."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.v_hidden_dropout_prob
        std = cfg.v_initializer_range
        self.feat_dense = Dense(cfg.v_feature_size, cfg.v_hidden_size, std,
                                self.dtype)
        self.loc_dense = Dense(cfg.num_locs, cfg.v_hidden_size, std,
                               self.dtype)
        self.layer_norm = LayerNorm(cfg.v_hidden_size,
                                    use_kernel=cfg.use_pallas_layernorm)

    def forward(self, feats, locs, seeds=None):
        x = self.layer_norm(self.feat_dense(feats) + self.loc_dense(locs))
        return _drop(self, x, self.rate, seeds).to(self.dtype)


class LxmertImageEmbeddings(nn.Module):
    """feature and location linears, each LN'd, averaged in the compute
    dtype (reference: volta/embeddings.py:149-172)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.v_hidden_dropout_prob
        std, kern = cfg.v_initializer_range, cfg.use_pallas_layernorm
        self.feat_dense = Dense(cfg.v_feature_size, cfg.v_hidden_size, std,
                                self.dtype)
        self.loc_dense = Dense(cfg.num_locs, cfg.v_hidden_size, std,
                               self.dtype)
        self.feat_ln = LayerNorm(cfg.v_hidden_size, use_kernel=kern)
        self.loc_ln = LayerNorm(cfg.v_hidden_size, use_kernel=kern)

    def forward(self, feats, locs, seeds=None):
        x = (self.feat_ln(self.feat_dense(feats))
             + self.loc_ln(self.loc_dense(locs))) / 2
        return _drop(self, x, self.rate, seeds).to(self.dtype)


DUAL_EMBEDDINGS = {
    "vilbert": ViLBertImageEmbeddings,
    "lxmert": LxmertImageEmbeddings,
}


# ============================================================ single-stream
def coordinate_embeddings(boxes, dim):
    """Sinusoidal embeddings of (x_c, y_c, w, h) * 100 over 1000^(i/dim)
    (reference: volta/embeddings.py:102-124). boxes [B,K,>=4] ->
    [B,K,4,2dim], in boxes' dtype."""
    xc = (boxes[..., 0] + boxes[..., 2]) / 2 * 100
    yc = (boxes[..., 1] + boxes[..., 3]) / 2 * 100
    w = (boxes[..., 2] - boxes[..., 0]) * 100
    h = (boxes[..., 3] - boxes[..., 1]) * 100
    pos = torch.stack([xc, yc, w, h], dim=-1)
    dim_mat = torch.pow(
        torch.tensor(1000.0, dtype=boxes.dtype, device=boxes.device),
        torch.arange(dim, dtype=boxes.dtype, device=boxes.device) / dim)
    ang = pos[..., None] / dim_mat
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class XavierDense(Dense):
    """A ``Dense`` (float32 compute unless ``dtype`` says otherwise) with
    Flax's xavier-uniform kernel init (U(-a, a), a = sqrt(6 / (in + out)))
    and a zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, 0.0, dtype)

    def reset_parameters(self, generator=None):
        out_f, in_f = self.weight.shape
        a = math.sqrt(6.0 / (in_f + out_f))
        with torch.no_grad():
            self.weight.uniform_(-a, a, generator=generator)
            self.bias.zero_()


class VLBertEmbeddings(nn.Module):
    """VL-BERT joint embeddings (reference: volta/embeddings.py:184-301):

      * all-zero feature rows are masked regions and take the learned
        ``object_mask_visual_embedding``;
      * ``obj_downsample``: dropout at ``v_attention_probs_dropout_prob``
        over [coordinates ‖ features], then a float32 xavier-initialised
        linear and a ReLU;
      * regions: their ``object_linguistic_embeddings`` row (the masked
        ones ``object_mask_word_embedding``, which exists only where
        ``visual_target_weights["6"] > 0``), the last region's replaced by
        ``end_embedding``, plus their LN'd visual feature, type 2;
      * text tokens: the word embedding plus the LN'd *last* region's
        visual feature;
      * joint position ids: text pads (pos >= text_end) skip the K region
        slots, the regions sit at text_end and the last at text_end + 1;
      * one LN and one dropout over [text ‖ regions]."""

    RAW_PARAMS = ("object_mask_visual_embedding",
                  "object_mask_word_embedding")

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        self.down_rate = cfg.v_attention_probs_dropout_prob
        self.coord_dim = cfg.v_coordinate_embeddings_dim
        self.std = std = cfg.initializer_range
        kern = cfg.use_pallas_layernorm
        hid, v_hid = cfg.hidden_size, cfg.v_hidden_size
        self.object_mask_visual_embedding = nn.Parameter(
            torch.empty(1, cfg.v_feature_size))
        self.obj_downsample = XavierDense(
            4 * 2 * self.coord_dim + cfg.v_feature_size, v_hid)
        if v_hid != hid:
            self.visual_1x1_object = Dense(v_hid, hid, std, self.dtype)
            self.visual_1x1_text = Dense(v_hid, hid, std, self.dtype)
        self.visual_ln_object = LayerNorm(hid, use_kernel=kern)
        self.object_linguistic_embeddings = Embed(1, hid, std)
        if cfg.visual_target_weights.get("6", 0) > 0:
            self.object_mask_word_embedding = nn.Parameter(
                torch.empty(1, hid))
        else:
            self.object_mask_word_embedding = None
        self.end_embedding = Embed(1, hid, std)
        self.word_embeddings = Embed(cfg.vocab_size, hid, std,
                                     zero_pad_row=True)
        self.visual_ln_text = LayerNorm(hid, use_kernel=kern)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, hid, std,
                                           fixed_order_grad=True)
        self.position_embeddings = Embed(cfg.max_position_embeddings, hid,
                                         std)
        self.layer_norm = LayerNorm(hid, use_kernel=kern)
        self.reset_own_parameters()

    def reset_own_parameters(self, generator=None):
        """The raw parameters' init: zeros, and N(0, std) for the mask
        word embedding."""
        with torch.no_grad():
            self.object_mask_visual_embedding.zero_()
            if self.object_mask_word_embedding is not None:
                self.object_mask_word_embedding.normal_(
                    0.0, self.std, generator=generator)

    def _vis(self, x, name):
        if hasattr(self, "visual_1x1_" + name):
            x = getattr(self, "visual_1x1_" + name)(x)
        return getattr(self, "visual_ln_" + name)(x)

    def forward(self, input_ids, feats, locs, token_type_ids, seeds=None):
        b, k = feats.shape[:2]
        seq = input_ids.shape[1]
        dev = input_ids.device
        mvrc = (feats == 0.0).all(-1, keepdim=True)  # [B,K,1]
        feats = torch.where(mvrc, self.object_mask_visual_embedding[0],
                            feats)
        coord = coordinate_embeddings(locs[..., :4].float(), self.coord_dim)
        down_in = torch.cat([coord.reshape(b, k, -1), feats], dim=-1)
        down_in = _drop(self, down_in, self.down_rate, seeds)
        final = F.relu(self.obj_downsample(down_in))

        obj_ling = _row(self.object_linguistic_embeddings, 0, (b, k))
        if self.object_mask_word_embedding is not None:
            obj_ling = torch.where(mvrc, self.object_mask_word_embedding[0],
                                   obj_ling)
        is_last = torch.arange(k, device=dev)[None, :, None] == k - 1
        obj_ling = torch.where(
            is_last, self.end_embedding.weight[0], obj_ling)
        text_vis = self._vis(final[:, -1:].expand(b, seq, final.shape[-1]),
                             "text")
        text_end = (input_ids != 0).sum(1, keepdim=True)  # [B,1]
        base = torch.arange(seq, device=dev)[None]
        text_pos = torch.where(base >= text_end, base + k, base)
        obj_pos = text_end.expand(b, k) + is_last[..., 0].long()
        t = (self.word_embeddings(input_ids) + text_vis
             + self.position_embeddings(text_pos)
             + self.token_type_embeddings(token_type_ids))
        v = (obj_ling + self._vis(final, "object")
             + self.position_embeddings(obj_pos)
             + _row(self.token_type_embeddings, 2, (b, k)))
        joint = self.layer_norm(torch.cat([t, v], dim=1))
        joint = _drop(self, joint, self.rate, seeds).to(self.dtype)
        return joint[:, :seq], joint[:, seq:]


class VisualBertEmbeddings(nn.Module):
    """VisualBERT joint embeddings (reference: volta/embeddings.py:304-398):
    the text sum; the regions' projection (compute dtype) plus their own
    position (ids 0) and type (ids 1) tables, which promotes to float32;
    one LN over [text ‖ regions]."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        std, hid = cfg.initializer_range, cfg.hidden_size
        _text_tables(self, cfg)
        self.projection = Dense(cfg.v_feature_size, hid, std, self.dtype)
        self.token_type_embeddings_visual = Embed(cfg.type_vocab_size, hid,
                                                  std)
        self.position_embeddings_visual = Embed(cfg.max_position_embeddings,
                                                hid, std)
        self.layer_norm = LayerNorm(hid, use_kernel=cfg.use_pallas_layernorm)

    def forward(self, input_ids, feats, locs, token_type_ids, seeds=None):
        b, k = feats.shape[:2]
        seq = input_ids.shape[1]
        t = _text_sum(self, input_ids, token_type_ids,
                      torch.arange(seq, device=input_ids.device))
        v = (self.projection(feats)
             + _row(self.position_embeddings_visual, 0, (b, k))
             + _row(self.token_type_embeddings_visual, 1, (b, k)))
        joint = self.layer_norm(torch.cat([t, v], dim=1))
        joint = _drop(self, joint, self.rate, seeds).to(self.dtype)
        return joint[:, :seq], joint[:, seq:]


class UniterEmbeddings(nn.Module):
    """UNITER joint embeddings (reference: volta/embeddings.py:401-457):
    text LN'd separately; vision = LN(featW) + LN(locW) + type(1), own LN.

    Dtype flow, as in the JAX module: the text sum and its LN are float32,
    then cast; ``feat_dense``/``loc_dense`` and their LNs run in the compute
    dtype; adding the float32 type row promotes to float32 before
    ``v_layer_norm`` and the final cast. In training mode the text and the
    vision embeddings each get dropout at ``hidden_dropout_prob`` before
    the cast (embeddings.py:306,317)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        std = cfg.initializer_range
        _text_tables(self, cfg)
        # the JAX module's LNs, volta_tpu/models/embeddings.py:304-316
        kern = cfg.use_pallas_layernorm
        self.layer_norm = LayerNorm(cfg.hidden_size, use_kernel=kern)
        self.feat_dense = Dense(cfg.v_feature_size, cfg.v_hidden_size, std,
                                self.dtype)
        self.feat_ln = LayerNorm(cfg.hidden_size, use_kernel=kern)
        self.loc_dense = Dense(cfg.num_locs, cfg.v_hidden_size, std,
                               self.dtype)
        self.loc_ln = LayerNorm(cfg.hidden_size, use_kernel=kern)
        self.v_layer_norm = LayerNorm(cfg.hidden_size, use_kernel=kern)

    def forward(self, input_ids, feats, locs, token_type_ids, seeds=None):
        b, k = feats.shape[:2]
        seq = input_ids.shape[1]
        t = self.layer_norm(_text_sum(
            self, input_ids, token_type_ids,
            torch.arange(seq, device=input_ids.device)))
        t = _drop(self, t, self.rate, seeds)
        img = self.feat_ln(self.feat_dense(feats))
        loc = self.loc_ln(self.loc_dense(locs))
        typ = self.token_type_embeddings(
            torch.ones((b, k), dtype=torch.long, device=feats.device))
        v = _drop(self, self.v_layer_norm(img + loc + typ), self.rate, seeds)
        return t.to(self.dtype), v.to(self.dtype)


SHARED_EMBEDDINGS = {
    "vl-bert": VLBertEmbeddings,
    "visualbert": VisualBertEmbeddings,
    "uniter": UniterEmbeddings,
}
