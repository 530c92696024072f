"""Pretraining and fine-tuning losses.

Counterpart of ``volta_tpu/losses.py``: the binary cross-entropy of the
fine-tuning heads (the cross entropy of the VL-logit and tri-classifier
heads is ``task_utils``'s, as in the JAX package), ``cross_entropy_ignore``
of the MLM and ITM heads, the seven masked-region criteria
(``PRE_VIS_CRITERIONS``, reference: volta/losses.py) and
``pretraining_losses``. ``image_label`` is 1 for masked regions, -1/0
elsewhere, and the region targets have lost the global image row already
(``train_step._strip_global``); ``pretraining_losses`` strips it from the
predictions.

The NCE criterion draws its negatives from a ``torch.Generator`` (JAX draws
them with ``jax.random`` from a key) with JAX's ranges and remaps
(``sample_negatives``); ``neg_idx`` overrides the draw. Its negative scores
run K8 on the card (``ops.nce``), the dense or blockwise composition on the
CPU, switched at JAX's ``_NCE_DENSE_SCORE_BYTES``.

Under data parallelism (``parallel.data_parallel``, rank r of W with rows
r·B to (r+1)·B of the global batch) each rank's loss is its share of the
global loss: its own sum over the global count (``parallel.sum_across``
of the counts), so that the gradients summed over the ranks are the
global batch's, as JAX's ``jnp.sum(valid)`` is the global sum under its
mesh (volta_tpu/losses.py:26-36, 51-62). NCE scores the rank's queries
against every rank's regions, with the global batch's draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .models.heads import PRE_VIS_TARGETS  # noqa: F401
from .ops.nce import _chunked_neg_scores, neg_scores  # noqa: F401
from .parallel import all_gather_rows, current_group, sum_across


def binary_cross_entropy_with_logits(logits, targets, reduction="mean"):
    """Numerically stable BCE on logits, computed in float32
    (volta_tpu/losses.py:39-48)."""
    logits = logits.float()
    targets = targets.float()
    per = torch.clamp(logits, min=0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def cross_entropy_ignore(logits, labels, ignore_index: int = -1):
    """Mean cross entropy over the positions whose label is not
    ``ignore_index``, divided by max(#valid, 1) (#valid over the global
    batch), in float32 (volta_tpu/losses.py:26-36)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, nll.new_zeros(()))
    return nll.sum() / sum_across(valid.sum()).clamp(min=1)


def _masked_mean_positions(loss_per_region, label):
    """sum(loss * [label==1]) / max(#masked, 1) (KL, xent, NCE; #masked
    over the global batch)."""
    m = (label == 1).float()
    return (loss_per_region * m).sum() / sum_across(m.sum()).clamp(min=1.0)


def _masked_mean_elements(loss_elem, label):
    """The masked mean over masked *elements* (MSE, Huber): the mask
    broadcast to the loss's shape (reference: volta/losses.py:30-31)."""
    m = (label == 1).float()[..., None].expand(loss_elem.shape)
    return (loss_elem * m).sum() / sum_across(m.sum()).clamp(min=1.0)


def kl_1601(pred, weight, label, image_cls=None, image_feat=None,
            obj_labels=None, obj_confs=None, attr_labels=None,
            attr_confs=None, generator=None):
    """KL divergence against the detector's soft class distribution, with
    0 log 0 = 0 (reference: volta/losses.py:16-22)."""
    if image_cls is None:
        return 0.0
    logp = F.log_softmax(pred.float(), dim=-1)
    tgt = image_cls.float()
    log_tgt = torch.where(tgt > 0, torch.log(tgt.clamp(min=1e-30)),
                          tgt.new_zeros(()))
    per_region = (tgt * (log_tgt - logp)).sum(-1)
    return weight * _masked_mean_positions(per_region, label)


def mse_2048(pred, weight, label, image_cls=None, image_feat=None,
             obj_labels=None, obj_confs=None, attr_labels=None,
             attr_confs=None, generator=None):
    """Feature regression (reference: volta/losses.py:25-33)."""
    if image_feat is None:
        return 0.0
    elem = torch.square(pred.float() - image_feat.float())
    return weight * _masked_mean_elements(elem, label)


def huber_2048(pred, weight, label, image_cls=None, image_feat=None,
               obj_labels=None, obj_confs=None, attr_labels=None,
               attr_confs=None, generator=None):
    """SmoothL1 feature regression (reference: volta/losses.py:108-116)."""
    if image_feat is None:
        return 0.0
    d = pred.float() - image_feat.float()
    ad = d.abs()
    elem = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    return weight * _masked_mean_elements(elem, label)


def _xent_conf(pred, weight, label, targets, confs, num_classes):
    """Hard-label cross entropy over the masked regions, the targets
    clipped into [0, num_classes), each term times its confidence where
    ``confs`` is given (volta_tpu/losses.py:103-113)."""
    logp = F.log_softmax(pred.float().reshape(-1, num_classes), dim=-1)
    t = targets.reshape(-1).long().clamp(0, num_classes - 1)
    nll = -torch.gather(logp, -1, t[:, None])[:, 0]
    if confs is not None:
        nll = nll * confs.reshape(-1).float()
    m = (label.reshape(-1) == 1).float()
    return weight * (nll * m).sum() / sum_across(m.sum()).clamp(min=1.0)


def xent_1600(pred, weight, label, image_cls=None, image_feat=None,
              obj_labels=None, obj_confs=None, attr_labels=None,
              attr_confs=None, generator=None):
    """Hard object labels x detector confidence
    (reference: volta/losses.py:86-94)."""
    if obj_labels is None or obj_confs is None:
        return 0.0
    return _xent_conf(pred, weight, label, obj_labels, obj_confs, 1600)


def xent_400(pred, weight, label, image_cls=None, image_feat=None,
             obj_labels=None, obj_confs=None, attr_labels=None,
             attr_confs=None, generator=None):
    """Hard attribute labels x confidence (reference: volta/losses.py:97-105)."""
    if attr_labels is None or attr_confs is None:
        return 0.0
    return _xent_conf(pred, weight, label, attr_labels, attr_confs, 400)


def xent_1601(pred, weight, label, image_cls=None, image_feat=None,
              obj_labels=None, obj_confs=None, attr_labels=None,
              attr_confs=None, generator=None):
    """Hard object labels, no confidence (reference: volta/losses.py:119-126)."""
    if obj_labels is None:
        return 0.0
    return _xent_conf(pred, weight, label, obj_labels, None, 1601)


# dense all-pairs score matrices beyond this many bytes switch the CPU twin
# to the blockwise one (volta_tpu/losses.py:180-187); K8 scores only the
# sampled pairs whatever the size
_NCE_DENSE_SCORE_BYTES = 1536 * 2**20
_NCE_CHUNK = 4096
# the opt-in shared-negative scheme (--nce_shared_negatives; see
# volta_tpu/losses.py:188-206): not the reference's per-query sampling
_NCE_SHARED_NEGATIVES = [False]


def _randint(low, high, shape, generator, device):
    """Draws from [low, high); ``low`` everywhere for an empty range, as
    ``jax.random.randint`` gives (b = 1 or r = 1)."""
    if high <= low:
        return torch.full(shape, low, dtype=torch.int64, device=device)
    return torch.randint(low, high, shape, generator=generator,
                         device=device)


def sample_negatives(b: int, r: int, num_negative: int,
                     generator: torch.Generator, device) -> torch.Tensor:
    """[b, r, N] flat row indices of the negatives of each query (N = 89 +
    38 = 127 for the nominal 128, int truncation as in the reference):
    cross-batch rows drawn from [0, b-1) with the query's own row remapped
    to b-1 and columns from [0, r); in-batch the own row and columns drawn
    from [0, r-1) with the own column remapped to r-1
    (volta_tpu/losses.py:259-283, reference volta/losses.py:43-60). Drawn
    from ``generator`` on its device."""
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)
    own = torch.arange(b, device=device)[:, None, None]
    own_col = torch.arange(r, device=device)[None, :, None]
    row_across = _randint(0, b - 1, (b, r, n_across), generator, device)
    row_across = torch.where(row_across == own, b - 1, row_across)
    col_across = _randint(0, r, (b, r, n_across), generator, device)
    col_inside = _randint(0, r - 1, (b, r, n_inside), generator, device)
    col_inside = torch.where(col_inside == own_col, r - 1, col_inside)
    return torch.cat([row_across * r + col_across, own * r + col_inside], -1)


def _score_dtype(pred, image_feat):
    return torch.promote_types(pred.dtype, image_feat.dtype)


def _global_regions(image_feat):
    """(every rank's regions [W·b, r, d] in rank order, the first global
    row of this rank's queries): ``image_feat`` and 0 outside a group."""
    g = current_group()
    if g is None:
        return image_feat, 0
    return all_gather_rows(image_feat), g.rank * image_feat.shape[0]


def _nce_shared(pred, weight, label, image_feat, generator, num_negative,
                idx_shared=None, col_inside=None):
    """Shared cross-batch negatives (volta_tpu/losses.py:208-237): one set
    of 89 candidate rows for every query of the step, drawn from [0, b·r)
    of the global batch (``idx_shared`` overrides it), plus 38 per-query
    in-image columns from [0, r-1) with the own column remapped to r-1
    (``col_inside``, the rank's rows of the global draw)."""
    b, r, d = image_feat.shape
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)
    dt = _score_dtype(pred, image_feat)
    predf, feat = pred.to(dt), image_feat.to(dt)
    regions, lo = _global_regions(image_feat)
    bg = regions.shape[0]
    flat = regions.to(dt).reshape(bg * r, d)
    device = pred.device
    if idx_shared is None:
        idx_shared = _randint(0, bg * r, (n_across,), generator, device)
    if col_inside is None:
        col_inside = _randint(0, r - 1, (bg, r, n_inside), generator,
                              device)[lo:lo + b]
        own_col = torch.arange(r, device=device)[None, :, None]
        col_inside = torch.where(col_inside == own_col, r - 1, col_inside)
    cross = torch.matmul(predf.float(), flat[idx_shared.long()].float().t())
    in_scores = torch.matmul(predf.float(), feat.float().transpose(1, 2))
    inside = torch.gather(in_scores, -1, col_inside.long())
    pos = (predf.float() * feat.float()).sum(-1)
    scores = torch.cat([pos[..., None], cross, inside], -1)
    nll = -F.log_softmax(scores, dim=-1)[..., 0]
    return weight * _masked_mean_positions(nll, label)


def nce_2048(pred, weight, label, image_cls=None, image_feat=None,
             obj_labels=None, obj_confs=None, attr_labels=None,
             attr_confs=None, generator=None, num_negative: int = 128,
             neg_idx=None, score_chunk=None):
    """Contrastive feature prediction against 127 sampled negatives, 70%
    cross-batch and 30% in-image, over every region with the masked-position
    mean at the end (volta_tpu/losses.py:240-321; reference:
    volta/losses.py:36-83). The scores run in the promoted dtype of
    ``pred`` and ``image_feat`` with float32 sums; the negatives' through
    ``ops.nce.neg_scores`` (K8 on the card), the positive's in float32 here.
    ``neg_idx`` [b, r, N] overrides the draw from ``generator`` (a fresh
    generator seeded 0 where none is given, as JAX takes ``PRNGKey(0)``);
    ``score_chunk`` picks the CPU twin's blockwise path, which scores
    beyond ``_NCE_DENSE_SCORE_BYTES`` take by themselves. Inside a group
    the candidates are every rank's regions (``parallel.all_gather_rows``,
    b the global batch) and each rank keeps its own queries' rows of the
    global draw, which every rank draws alike from its generator; a given
    ``neg_idx`` is the rank's rows, indexing the global regions."""
    if image_feat is None:
        return 0.0
    b, r, d = image_feat.shape
    if generator is None and neg_idx is None:
        generator = torch.Generator(pred.device).manual_seed(0)
    if neg_idx is None and _NCE_SHARED_NEGATIVES[0]:
        return _nce_shared(pred, weight, label, image_feat, generator,
                           num_negative)
    regions, lo = _global_regions(image_feat)
    bg = regions.shape[0]
    if neg_idx is None:
        neg_idx = sample_negatives(bg, r, num_negative, generator,
                                   pred.device)[lo:lo + b]
    dt = _score_dtype(pred, image_feat)
    flat = regions.reshape(bg * r, d).to(dt)
    predf = pred.to(dt)
    if score_chunk is None and b * r * bg * r * 4 > _NCE_DENSE_SCORE_BYTES:
        score_chunk = _NCE_CHUNK
    negs = neg_scores(predf, flat, neg_idx, score_chunk)
    pos = (predf.float() * image_feat.float()).sum(-1)
    scores = torch.cat([pos[..., None], negs], -1)
    nll = -F.log_softmax(scores, dim=-1)[..., 0]  # the positive is class 0
    return weight * _masked_mean_positions(nll, label)


PRE_VIS_CRITERIONS = {
    "0": kl_1601,
    "1": mse_2048,
    "2": nce_2048,
    "3": xent_1600,
    "4": xent_400,
    "5": huber_2048,
    "6": xent_1601,
}


def strip_global_rows(cfg, x):
    """x [b, r(+1), ...] without the global image row that
    ``add_global_imgfeat`` adds first or last."""
    if cfg.add_global_imgfeat == "first":
        return x[:, 1:]
    if cfg.add_global_imgfeat == "last":
        return x[:, :-1]
    return x


def pretraining_losses(cfg, outputs: Dict, *, masked_lm_labels=None,
                       image_label=None, image_cls=None, image_feat=None,
                       obj_labels=None, obj_confs=None, attr_labels=None,
                       attr_confs=None, next_sentence_label=None,
                       generator: Optional[torch.Generator] = None):
    """(MLM, masked-region, ITM) losses (volta_tpu/losses.py:335-365,
    reference: volta/encoders.py:1080-1112): each criterion of
    ``cfg.visual_target_weights`` with a positive weight on its
    ``mrm_logits`` less the global row, summed; the MLM cross entropy where
    labels are given; the ITM cross entropy where the model has an ITM head
    and labels are given. A term that is absent is the float 0.0."""
    img_loss = 0.0
    for ix, weight in cfg.visual_target_weights.items():
        if weight <= 0:
            continue
        scores = strip_global_rows(cfg, outputs["mrm_logits"][ix])
        img_loss = img_loss + PRE_VIS_CRITERIONS[ix](
            scores, weight, image_label, image_cls, image_feat,
            obj_labels, obj_confs, attr_labels, attr_confs,
            generator=generator)
    mlm = cross_entropy_ignore(outputs["mlm_logits"], masked_lm_labels) \
        if masked_lm_labels is not None else 0.0
    itm = 0.0
    if outputs["itm_logits"] is not None and next_sentence_label is not None:
        itm = cross_entropy_ignore(outputs["itm_logits"], next_sentence_label)
    return mlm, img_loss, itm
