"""One rank of a gloo group for tests/test_torch_port_distributed.py, and
the one-process run it is held to.

    python tests/_torch_dp_worker.py <spec.pt> <rank> <world> <store> <out.pt>

joins a gloo group of ``world`` ranks through the file store ``store``,
runs every case of the spec (``run``) on the rank's batches and saves what
it saw to ``out.pt``. The test calls ``run`` in its own process, with no
group, on the ranks' batches concatenated a step. The worker imports the
port and never JAX.

A spec (a dict the test ``torch.save``s): ``kind`` "task" or "pretrain",
``weights`` (the model's state dict), ``task_cfg`` (task), ``opt`` (the
optimizer's arguments), ``batches`` [rank][step] (numpy dicts), and
``cases``: each a dict of ``name``, ``config`` (a ``VoltaConfig`` dict),
``train`` (the model's mode), ``steps`` and, for pretraining,
``objective``, ``grad_acc`` and ``neg_idx`` (the global NCE draws a step,
fed in through ``losses.sample_negatives``, or None to draw them).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _spies(counts):
    """Count the calls of row 9's and row 14's entries (their twins run
    on the CPU, which counts no launch)."""
    from volta_tpu_torch.models import encoder, layers

    real_hm = encoder.dropout_attention_hidden_masks
    real_km = layers.dropout_mask.keep_mask

    def hm(*a, **k):
        counts["hidden_masks"] += 1
        return real_hm(*a, **k)

    def km(*a, **k):
        counts["keep_mask"] += 1
        return real_km(*a, **k)

    encoder.dropout_attention_hidden_masks = hm
    layers.dropout_mask.keep_mask = km
    return lambda: (setattr(encoder, "dropout_attention_hidden_masks",
                            real_hm),
                    setattr(layers.dropout_mask, "keep_mask", real_km))


def _fed_negatives(draws):
    """``losses.sample_negatives`` returning ``draws`` in turn (the global
    [b, r, N] draws, one a call); returns the restore function."""
    import torch

    from volta_tpu_torch import losses

    real, it = losses.sample_negatives, iter(draws)
    losses.sample_negatives = \
        lambda b, r, n, g, device: torch.tensor(next(it), device=device)
    return lambda: setattr(losses, "sample_negatives", real)


def _model(spec, cfg):
    from volta_tpu_torch.models import VoltaForVLPreTraining, \
        VoltaForVLTasks

    if spec["kind"] == "pretrain":
        return VoltaForVLPreTraining(cfg)
    return VoltaForVLTasks(cfg, spec["task_cfg"], ("TASK1",))


def run(spec, batches):
    """Every case of ``spec`` on ``batches`` [step] (this rank's, or the
    global batches without a group): {name: {losses, params (a state dict
    after each step), calls (rows 9 and 14)}}."""
    import collections

    import torch

    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.optimization import build_optimizer, \
        warmup_linear_schedule
    from volta_tpu_torch.parallel import broadcast_state
    from volta_tpu_torch.train_step import create_train_state, \
        make_pretrain_step, make_task_train_step

    out = {}
    for case in spec["cases"]:
        cfg = VoltaConfig.from_dict(case["config"])
        model = _model(spec, cfg)
        model.load_state_dict(spec["weights"])
        model.train(case["train"])
        o = spec["opt"]
        opt = build_optimizer(
            "adamw", warmup_linear_schedule(o["lr"], o["warmup"],
                                            o["total"]),
            model, weight_decay=o["wd"], clip_norm=o["clip"],
            betas=o["betas"], eps=o["eps"],
            grad_accum_steps=case.get("grad_acc", 1))
        state = create_train_state(model, opt, seed=case.get("seed", 0))
        broadcast_state(state)
        if spec["kind"] == "pretrain":
            step = make_pretrain_step(model, opt, cfg,
                                      objective=case["objective"])
        else:
            step = make_task_train_step(model, opt, spec["task_cfg"],
                                        "TASK1")
        counts = collections.Counter()
        restore = [_spies(counts)]
        if case.get("neg_idx") is not None:
            restore.append(_fed_negatives(case["neg_idx"]))
        try:
            losses, params = [], []
            for i in range(case["steps"]):
                losses.append(float(step(state, batches[i])["loss"]))
                params.append({k: v.detach().clone()
                               for k, v in model.state_dict().items()})
        finally:
            for r in restore:
                r()
        out[case["name"]] = {"losses": losses, "params": params,
                             "calls": dict(counts)}
    return out


def main():
    import torch
    import torch.distributed as dist

    spec_path, rank, world, store, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        spec = torch.load(spec_path, weights_only=False)
        out = run(spec, spec["batches"][rank])
        out["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "volta_tpu"))
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
