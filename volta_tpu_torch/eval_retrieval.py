"""Image-text retrieval evaluation (COCO / Flickr30k) of a model of the
port.

Counterpart of the root ``eval_retrieval.py`` (its flags :33-73 and its
loop :76-255):

    python -m volta_tpu_torch.eval_retrieval --config_file configs/ctrl_uniter_base.json \\
        --tasks_config_file config_tasks/ctrl_test_tasks.yml --task 8 \\
        --from_pretrained weights.bin --output_dir results

It builds the caption x gallery score matrix one dispatch at a time: the
gallery's chunks (``gallery_chunk`` images each, features, boxes and masks)
go to the card once, and a dispatch ships only ``--captions_per_forward``
captions, which the forward expands against one chunk (each caption
repeated ``chunk`` times in a row, ``repeat_interleave`` as ``jnp.repeat``;
the chunk tiled once a caption, ``repeat``), one batch of captions x chunk
pairs. The tail block is padded with the last caption and its rows
dropped. Scores are the task head's logit (``VL-logit``), or with
``--zero_shot`` the pretraining ITM head's softmax, column 0
(``VoltaForVLPreTraining``; only the ITM path runs, the part of the
forward that JAX's compiled program keeps). ``--quantize int8`` serves
every ``Dense`` through K9 (``ops.int8_dense``: the dynamic per-token
bundle, the other parameters cast to ``export.quantize_residual_dtype``).
``--max_captions N`` scores the first N captions. It logs the throughput
(pairs/s) and writes the R@1/5/10, median and mean rank of image and text
retrieval, ``<split>_result.json`` (each caption's top 20 images) and
``<split>_metrics.json`` as the JAX CLI does. ``--drop_last``,
``--use_chunk`` and ``--local_rank`` are accepted and unused, as there.
``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--from_pretrained", default="", type=str)
    p.add_argument("--bert_model", default="bert-base-uncased", type=str)
    p.add_argument("--config_file", default="configs/ctrl_uniter_base.json",
                   type=str)
    p.add_argument("--output_dir", default="results", type=str)
    p.add_argument("--save_name", default="", type=str)
    p.add_argument("--tasks_config_file",
                   default="config_tasks/ctrl_test_tasks.yml", type=str)
    p.add_argument("--task", default="8", type=str)
    p.add_argument("--split", default="", type=str)
    p.add_argument("--do_lower_case", action="store_true", default=True)
    p.add_argument("--vocab_file", default="", type=str)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--in_memory", default=False, type=bool)
    p.add_argument("--zero_shot", action="store_true")
    p.add_argument("--captions_per_forward", type=int, default=4,
                   help="captions scored per dispatch against the "
                        "card-resident gallery chunk (effective batch = "
                        "this x gallery_chunk)")
    p.add_argument("--max_captions", type=int, default=0,
                   help="score only the first N captions (throughput "
                        "benchmarking; metrics then cover the subset)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="score with int8 dense layers (weight and "
                        "activation, int32 accumulation; "
                        "volta_tpu_torch/ops/int8_dense.py)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    # accepted for reference-script drop-in compat; no-ops here
    p.add_argument("--drop_last", action="store_true")
    p.add_argument("--use_chunk", default=0, type=float)
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def recall_metrics(rank_matrix):
    n = len(rank_matrix)
    return {
        "r1": 100.0 * float(np.sum(rank_matrix < 1)) / n,
        "r5": 100.0 * float(np.sum(rank_matrix < 5)) / n,
        "r10": 100.0 * float(np.sum(rank_matrix < 10)) / n,
        "medr": float(np.floor(np.median(rank_matrix) + 1)),
        "meanr": float(np.mean(rank_matrix) + 1),
    }


def itm_logits(model, input_ids, image_feat, image_loc, token_type_ids,
               attention_mask, image_attention_mask):
    """The ITM logits of ``VoltaForVLPreTraining`` in eval mode without its
    MLM and masked-region heads, which the scores do not read."""
    from .models.heads import fuse_pooled

    head = model.cls.bi_seq_relationship
    if head is None:
        raise ValueError("--zero_shot needs an ITM head; fusion_method "
                         f"{model.cfg.fusion_method!r} has none")
    _, _, pooled_t, pooled_v = model.bert(
        input_ids, image_feat, image_loc, token_type_ids, attention_mask,
        image_attention_mask)
    return head(fuse_pooled(model.cfg, pooled_t, pooled_v))


def make_forward(model, task: str, zero_shot: bool, cb: int, chunk: int):
    """One dispatch: ``cb`` captions (ids, segments, masks, on the card)
    against one gallery chunk (features, boxes, masks) -> scores ``[cb,
    chunk]``."""
    @torch.no_grad()
    def forward(q, seg, im, f, s, vm):
        qq, gg, mm = (t.repeat_interleave(chunk, 0) for t in (q, seg, im))
        ff, ss = f.repeat(cb, 1, 1), s.repeat(cb, 1, 1)
        vv = vm.repeat(cb, 1)
        if zero_shot:
            logits = itm_logits(model, qq, ff, ss, gg, mm, vv)
            return torch.softmax(logits, dim=1)[:, 0].reshape(cb, chunk)
        pred = model(qq, ff, ss, task, gg, mm, vv)
        return pred[:, 0].reshape(cb, chunk)

    return forward


def setup(args):
    """Config, data and the served model for ``args``: ``(model, task,
    tc, dataset)``, the model in eval mode on ``args.device``, quantized
    with ``--quantize int8``. Raises SystemExit for ``--device cuda`` on a
    host without a card."""
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("eval_retrieval: --device cuda but CUDA is not "
                         "available (pass --device cpu to run on the CPU)")
    from .checkpoint import from_pretrained
    from .config import VoltaConfig
    from .models import VoltaForVLPreTraining, VoltaForVLTasks
    from .models.layers import init_weights
    from .task_utils import load_dataset_eval, load_task_config, task_key
    from .train_utils import set_seed

    set_seed(args.seed)
    cfg = VoltaConfig.from_json_file(args.config_file)
    cfg.compute_dtype = args.compute_dtype
    if args.no_pallas:
        cfg.use_pallas = False
    task_cfg = load_task_config(args.tasks_config_file)
    task = task_key(args.task)
    ds = load_dataset_eval(args, cfg, task_cfg, args.task)["dataset"]
    model = VoltaForVLPreTraining(cfg) if args.zero_shot \
        else VoltaForVLTasks(cfg, task_cfg, (task,))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    if args.from_pretrained:
        report = from_pretrained(cfg, model, args.from_pretrained)
        logger.info("loaded %d tensors", len(report["loaded"]))
    model = model.to(args.device).eval()
    if args.quantize == "int8":
        from .export import quantize_residual_dtype
        from .ops.int8_dense import quantize_model, quantize_variables

        quantize_model(model, quantize_variables(
            model, residual_dtype=quantize_residual_dtype(cfg)))
    return model, task, task_cfg[task], ds


def main(argv=None):
    """Score, rank and write the results; returns {image_retrieval,
    text_retrieval, score_matrix, pairs_per_s, seconds, dispatches,
    save_path, forward, gallery, captions, model}: ``forward(block,
    chunk_idx)`` scores one dispatch of the caption block ``captions(c0)``
    (the tail padded) against the card-resident chunk
    ``gallery[chunk_idx]`` with the served ``model``."""
    args = parse_args(argv)
    model, task, tc, ds = setup(args)
    device = torch.device(args.device)
    chunk = ds.gallery_chunk
    n_images = ds.num_images
    n_captions = len(ds.entries)
    if args.max_captions:
        n_captions = min(n_captions, args.max_captions)
    cb = max(1, args.captions_per_forward)
    fwd = make_forward(model, task, args.zero_shot, cb, chunk)

    # gallery chunks to the card once; per-dispatch transfers are captions
    gallery = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in ds.gallery(gi)) for gi in range(ds.num_chunks)]

    def captions(c0):
        # the tail block padded by repeating the last caption
        caps = [ds.caption(min(c0 + k, n_captions - 1)) for k in range(cb)]
        return tuple(torch.from_numpy(np.stack([c[i] for c in caps]))
                     .to(device) for i in (0, 2, 1))  # ids, segments, mask

    def forward(block, gi):
        return fwd(*block, *gallery[gi])

    score_matrix = np.zeros((n_captions, ds.num_chunks * chunk), np.float32)
    target_matrix = np.zeros_like(score_matrix)
    # a warm-up dispatch (kernel build, library set-up) off the clock
    forward(captions(0), 0).float().cpu()
    dispatches = 0
    t_score = time.perf_counter()
    for c0 in range(0, n_captions, cb):
        block = captions(c0)
        rows = min(cb, n_captions - c0)
        for gi in range(ds.num_chunks):
            scores = forward(block, gi).float().cpu().numpy()
            dispatches += 1
            cols = slice(gi * chunk, (gi + 1) * chunk)
            score_matrix[c0:c0 + rows, cols] = scores[:rows]
            for k in range(rows):
                target_matrix[c0 + k, cols] = ds.target_row(c0 + k, gi)
        if (c0 // cb) % max(1, 200 // cb) == 0:
            logger.info("caption %d/%d", c0, n_captions)
    dt = time.perf_counter() - t_score
    pairs_per_s = n_captions * n_images / dt
    logger.info("score matrix in %.1fs: %.1f captions/s, %.0f pairs/s",
                dt, n_captions / dt, pairs_per_s)

    score_matrix = score_matrix[:, :n_images]
    target_matrix = target_matrix[:, :n_images]

    # image retrieval: rank of the true image per caption
    order = np.argsort(-score_matrix, axis=1)
    true_img = target_matrix.argmax(axis=1)
    rank_matrix = np.array(
        [np.where(order[i] == true_img[i])[0][0]
         for i in range(n_captions)], np.float32)
    ir = recall_metrics(rank_matrix)
    print("**** Image Retrieval ****")
    print("Final r1:%.3f, r5:%.3f, r10:%.3f, medr:%.3f, meanr:%.3f" % (
        ir["r1"], ir["r5"], ir["r10"], ir["medr"], ir["meanr"]))

    # text retrieval: best rank among the image's captions
    tr_ranks = np.zeros(n_images, np.float32)
    for j in range(n_images):
        tgt = np.where(target_matrix[:, j] == 1)[0]
        sorted_c = np.argsort(-score_matrix[:, j])
        tr_ranks[j] = min(np.where(sorted_c == t)[0][0] for t in tgt) \
            if len(tgt) else n_captions
    tr = recall_metrics(tr_ranks)
    print("**** Text Retrieval ****")
    print("Final r1:%.3f, r5:%.3f, r10:%.3f, medr:%.3f, meanr:%.3f" % (
        tr["r1"], tr["r5"], tr["r10"], tr["medr"], tr["meanr"]))

    save_path = os.path.join(
        args.output_dir,
        f"{tc['name']}_{os.path.basename(args.config_file)}-"
        f"{args.save_name or 'base'}")
    os.makedirs(save_path, exist_ok=True)
    split = args.split or tc["val_split"]
    results = [order[i].tolist()[:20] for i in range(n_captions)]
    with open(os.path.join(save_path, split + "_result.json"), "w") as f:
        json.dump(results, f)
    with open(os.path.join(save_path, split + "_metrics.json"), "w") as f:
        json.dump({"image_retrieval": ir, "text_retrieval": tr}, f)
    return {"image_retrieval": ir, "text_retrieval": tr,
            "score_matrix": score_matrix, "pairs_per_s": pairs_per_s,
            "seconds": dt, "dispatches": dispatches, "save_path": save_path,
            "forward": forward, "gallery": gallery, "captions": captions,
            "model": model}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
