"""Evaluate a model of the port on a task split and dump its predictions.

Counterpart of the root ``eval_task.py`` for the VL-classifier path:

    python -m volta_tpu_torch.eval_task --config_file configs/ctrl_uniter_base.json \
        --tasks_config_file config_tasks/ctrl_trainval_tasks.yml --task 1 \
        --from_pretrained weights.pt --output_dir results

It logs ``eval loss … score …`` and writes ``<split>_result.json`` as the
JAX CLI does. ``--device`` defaults to ``cuda`` and never falls back to the
CPU; ``--from_pretrained`` takes a ``torch.save``d state dict of the port
(``convert.state_dict_from_flax`` makes one from Flax params), or a
``train_task`` checkpoint (its ``train_state.pt`` or the directory holding
it). Without it the weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

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
    p.add_argument("--task", default="1", type=str)
    p.add_argument("--split", default="", type=str)
    p.add_argument("--do_lower_case", action="store_true", default=True)
    p.add_argument("--vocab_file", default="", type=str)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--in_memory", default=False, type=bool)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def collect_results(task_type, prediction, batch, dataset, results):
    """Prediction records for the VL-classifier heads
    (reference: volta/task_utils.py:540-616)."""
    pred = np.asarray(prediction)
    qids = np.asarray(batch["question_id"])
    if task_type == "VL-classifier":
        for qid, row in zip(qids, pred.argmax(1)):
            results.append({"question_id": int(qid),
                            "answer": dataset.label2ans[int(row)]})
    elif task_type == "VL-classifier-GQA":
        for qid, row in zip(qids, pred.argmax(1)):
            true_qid = dataset.entries[int(qid)]["question_id"]
            results.append({"questionId": str(true_qid),
                            "prediction": dataset.label2ans[int(row)]})
    else:
        raise NotImplementedError(f"task type {task_type!r} is not ported")
    return results


def setup(args):
    """Config, task config, eval data and model for ``args``:
    ``(model, task_cfg, task, data)``. Raises SystemExit for ``--device
    cuda`` on a host without a card."""
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("eval_task: --device cuda but CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    from .config import VoltaConfig
    from .models import VoltaForVLTasks
    from .models.layers import init_weights
    from .task_utils import load_dataset_eval, load_task_config, task_key

    np.random.seed(args.seed)
    cfg = VoltaConfig.from_json_file(args.config_file)
    cfg.compute_dtype = args.compute_dtype
    task_cfg = load_task_config(args.tasks_config_file)
    task = task_key(args.task)
    tc = task_cfg[task]
    if tc.get("fusion_method"):
        # per-task pooling override (reference: eval_task.py:116-118)
        cfg.fusion_method = tc["fusion_method"]

    data = load_dataset_eval(args, cfg, task_cfg, args.task)
    if "num_labels" not in tc and hasattr(data["dataset"], "num_labels"):
        tc["num_labels"] = data["dataset"].num_labels

    model = VoltaForVLTasks(cfg, task_cfg, (task,))
    if args.from_pretrained:
        path = args.from_pretrained
        if os.path.isdir(path):  # a train_task ckpt/ or best/ directory
            path = os.path.join(path, "train_state.pt")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd.get("model"), dict):  # a train_task train state
            sd = sd["model"]
        model.load_state_dict(sd, strict=True)
        logger.info("loaded %d tensors", len(sd))
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(args.device).eval(), task_cfg, task, data


def main(argv=None):
    """Run the eval; returns {loss, score, n, nonfinite_batches, out_file}."""
    from .eval_step import make_task_eval_step

    args = parse_args(argv)
    model, task_cfg, task, data = setup(args)
    tc = task_cfg[task]
    ds, loader = data["dataset"], data["loader"]
    eval_step = make_task_eval_step(model, task_cfg, task)

    results = []
    total_loss = total_score = 0.0
    total_n = nonfinite = 0
    for batch in loader:
        out = eval_step(batch)
        # the predictions are the output, so they come to the host per batch
        pred = out["prediction"].float().cpu().numpy()
        nonfinite += int(not np.isfinite(pred).all())
        collect_results(tc["type"], pred, batch, ds, results)
        total_loss += float(out["loss"])
        total_score += float(out["score"])
        total_n += int(out["batch_size"])
    if nonfinite:
        logger.warning("%d batches gave non-finite logits", nonfinite)
    if total_n:
        logger.info("eval loss %.4f score %.4f", total_loss / total_n,
                    total_score / total_n)

    save_path = os.path.join(
        args.output_dir,
        f"{tc['name']}_{os.path.basename(args.config_file)}-"
        f"{args.save_name or 'base'}")
    os.makedirs(save_path, exist_ok=True)
    split = args.split or tc["val_split"]
    out_file = os.path.join(save_path, split + "_result.json")
    with open(out_file, "w") as f:
        json.dump(results, f)
    logger.info("wrote %d predictions to %s", len(results), out_file)
    return {"loss": total_loss / max(total_n, 1),
            "score": total_score / max(total_n, 1), "n": total_n,
            "nonfinite_batches": nonfinite, "out_file": out_file}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
