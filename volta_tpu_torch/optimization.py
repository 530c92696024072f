"""The fine-tuning optimizer and its learning-rate schedules.

Counterpart of ``volta_tpu/optimization.py`` (which imports JAX and optax):
the schedules (:27-62), ``no_decay_mask`` (:66-115) on the port's parameter
names, and AdamW with ``correct_bias=False`` (:119-172) behind the global-
norm clip, assembled as ``build_optimizer`` (:325-365) does it for
``"adamw"``. The update is the optax chain, step for step:

    g <- g * max_norm / max(||g||, max_norm)          clip_by_global_norm
    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    u <- m / (sqrt(v) + eps)                          (bias-corrected m, v
                                                       with correct_bias)
    u <- u + wd * p       where the mask decays p     add_decayed_weights,
                                                      from the pre-update p
    p <- p - lr(count) * u,  count <- count + 1       scale_by_learning_rate

so the schedule is read at the number of updates already made: with warmup
the first step's lr is 0. Bias correction counts its own updates
(``adam_count``, optax's ``ScaleByAdamState.count``): a run resumed from
the reference's tar takes the schedule's position from its
``global_step`` and this count from its moments' ``step``
(volta_tpu/checkpoint.py:535-560), which may differ.
``torch.optim.AdamW`` always corrects the bias and decays the post-update
parameter, so it is not this. The update runs as
``torch._foreach_*`` ops over all parameters at once and reads nothing back
to the host.

With ``grad_accum_steps`` K > 1 the chain sits inside ``optax.MultiSteps``
(:363-364): each call folds its gradients into their running mean,
acc <- acc + (g - acc) / (n + 1) as optax's ``use_grad_mean`` does, and
only every K-th call clips that mean and takes one AdamW update and one
schedule tick; the parameters are untouched in between. Parameters named
in ``frozen`` (``train_utils.apply_freeze``) have their gradient zeroed
before all of it, as ``optax.masked(optax.set_to_zero())`` ahead of the
chain does (volta_tpu/train_utils.py:199-207): they still take weight decay
and what momentum they have.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]


# ---------------------------------------------------------------- schedules
# float32 arithmetic, as the JAX schedules compute it
def warmup_linear_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Schedule:
    """Linear warmup then linear decay to 0
    (pytorch_transformers WarmupLinearSchedule semantics)."""
    f = np.float32

    def fn(step):
        s = f(step)
        w = f(max(warmup_steps, 1))
        t = f(max(total_steps, 1))
        decay = max(f(0.0), (t - s) / max(f(1.0), t - w))
        return float(f(base_lr) * (s / w if step < warmup_steps else decay))

    return fn


def warmup_constant_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup then constant."""
    f = np.float32

    def fn(step):
        w = f(max(warmup_steps, 1))
        return float(f(base_lr) * (f(step) / w if step < warmup_steps
                                   else f(1.0)))

    return fn


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: float(np.float32(base_lr))


SCHEDULES = {
    "warmup_linear": warmup_linear_schedule,
    "warmup_constant": lambda lr, w, t: warmup_constant_schedule(lr, w),
    "constant": lambda lr, w, t: constant_schedule(lr),
}


# ------------------------------------------------------------------- masks
# LayerNorm scales the reference trainers DO decay, because their no_decay
# filter matches names and these norms' torch names miss it (see
# volta_tpu/optimization.py:66-82 for the reference lines)
_DECAYED_LN_SCALES = (
    ("embeddings", "feat_ln"),          # uniter image_layer_norm
    ("embeddings", "loc_ln"),           # uniter image_location_layer_norm
    ("embeddings", "visual_ln_text"),   # vl-bert
    ("embeddings", "visual_ln_object"),  # vl-bert
)


def _flax_leaf(module: nn.Module, pname: str) -> str:
    """The Flax leaf name of parameter ``pname`` of ``module``."""
    from .models.layers import Dense, Embed, LayerNorm

    if pname == "bias":
        return "bias"
    for cls, leaf in ((LayerNorm, "scale"), (Dense, "kernel"),
                      (Embed, "embedding")):
        if isinstance(module, cls):
            return leaf
    raise KeyError(f"no Flax counterpart for {type(module).__name__}."
                   f"{pname}")


def _decays(names) -> bool:
    """volta_tpu.optimization.no_decay_mask's rule on a Flax path."""
    leaf = names[-1]
    if leaf == "bias" or leaf.endswith("_bias"):
        return False
    if leaf == "scale":
        if len(names) < 3:
            return False
        mod, ln = names[-3], names[-2]
        return (mod, ln) in _DECAYED_LN_SCALES or (
            mod.startswith("clf_") and ln == "ln")
    return not any(n == "ln" or n.endswith("_ln") or "layer_norm" in n
                   for n in names)


def flax_paths(model: nn.Module) -> Dict[str, list]:
    """Each parameter's name -> its path in the Flax tree: the port's names
    are the Flax tree's with ``weight`` for ``scale`` / ``kernel`` /
    ``embedding``."""
    out = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = (
                mname.split(".") if mname else []) + [
                _flax_leaf(module, pname)]
    return out


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies, by parameter name: bias and
    LayerNorm weight/bias are excluded, except the reference's name-based
    blind spots (``embeddings.feat_ln`` / ``loc_ln`` weights, the
    ``clf_*.ln`` weights), which it decays and so does this. The JAX rule
    applies to the parameter's Flax path (``flax_paths``)."""
    return {n: _decays(path) for n, path in flax_paths(model).items()}


# ------------------------------------------------------------------- adamw
class AdamW:
    """AdamW over ``named_params`` with the optax chain above. ``schedule``
    maps the update count to the learning rate (a float is a constant);
    ``decay`` maps names to whether weight decay applies (all, if None);
    ``clip_norm`` enables the global-norm clip; ``grad_accum_steps`` K
    makes every K-th ``step`` an update of the mean gradient; ``frozen``
    holds the indices of the parameters whose gradient is zeroed."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Union[Schedule, float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay: Optional[Dict[str, bool]] = None,
                 clip_norm: Optional[float] = None,
                 correct_bias: bool = False, grad_accum_steps: int = 1):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule = schedule if callable(schedule) \
            else constant_schedule(schedule)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.clip_norm = float(clip_norm) if clip_norm else None
        self.correct_bias = correct_bias
        self.decayed = [i for i, n in enumerate(self.names)
                        if weight_decay > 0 and (decay is None or decay[n])]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.adam_count = 0
        self.frozen = set()
        self.accum_steps = int(grad_accum_steps)
        self.mini_step = 0  # gradients in the running mean, < accum_steps
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.accum_steps > 1 else None

    def lr(self, count: Optional[int] = None) -> float:
        return self.schedule(self.count if count is None else count)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One micro-step from the parameters' ``.grad`` (a parameter
        without one counts as a zero gradient, as in the JAX step): an
        update, or with K > 1 a fold into the running mean that updates on
        every K-th call."""
        grads = [p.grad if p.grad is not None and i not in self.frozen
                 else torch.zeros_like(p) for i, p in enumerate(self.params)]
        if self.acc is not None:
            # optax.MultiSteps' Welford mean, divided by a tensor: CUDA's
            # division by a Python float multiplies by its reciprocal
            n = self.mini_step
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, torch.tensor(
                float(n + 1), device=self.params[0].device))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)

    def _update(self, grads):
        """clip -> AdamW on ``grads``; one schedule tick."""
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            factor = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
            grads = torch._foreach_mul(grads, factor)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu, nu = self.mu, self.nu
        if self.correct_bias:
            t = self.adam_count + 1
            mu = torch._foreach_div(mu, 1 - b1 ** t)
            nu = torch._foreach_div(nu, 1 - b2 ** t)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, denom)
        if self.decayed:
            torch._foreach_add_([upd[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed],
                                alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr())
        torch._foreach_add_(self.params, upd)
        self.count += 1
        self.adam_count += 1

    def state_dict(self) -> Dict:
        out = {"count": self.count, "adam_count": self.adam_count,
               "mu": dict(zip(self.names, self.mu)),
               "nu": dict(zip(self.names, self.nu))}
        if self.acc is not None:
            out.update(mini_step=self.mini_step,
                       acc=dict(zip(self.names, self.acc)))
        return out

    def load_state_dict(self, state: Dict):
        """Restore the counts, the moments and, with K > 1, the running
        mean, each tensor by its parameter's name (a name missing from
        ``state`` raises)."""
        self.count = int(state["count"])
        self.adam_count = int(state.get("adam_count", self.count))
        self.mini_step = int(state.get("mini_step", 0))
        with torch.no_grad():
            for i, n in enumerate(self.names):
                self.mu[i].copy_(state["mu"][n])
                self.nu[i].copy_(state["nu"][n])
                if self.acc is not None:
                    self.acc[i].copy_(state["acc"][n] if "acc" in state
                                      else torch.zeros_like(self.acc[i]))


def build_optimizer(name: str, schedule, model: nn.Module, *,
                    weight_decay: float = 0.01,
                    clip_norm: Optional[float] = None,
                    grad_accum_steps: int = 1, betas=None,
                    eps: Optional[float] = None,
                    correct_bias: bool = False, state_dtype=None,
                    lr_scales=None,
                    skip_disconnected_params: bool = False) -> AdamW:
    """The optimizer of ``volta_tpu.optimization.build_optimizer`` for
    ``model``'s parameters: clip -> AdamW (+ the no-decay mask), inside
    the K-step accumulation with ``grad_accum_steps``. Only the AdamW
    branch is ported; the rest raises."""
    if name != "adamw":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 8, RAdam and the other optimizers)")
    if state_dtype is not None or lr_scales is not None \
            or skip_disconnected_params:
        raise NotImplementedError(
            "reduced-precision moments, per-parameter lr scales and "
            "skip_disconnected are not ported yet (ROADMAP.md Queue 1 "
            "item 8)")
    kw = {}
    if betas is not None:
        kw["b1"], kw["b2"] = float(betas[0]), float(betas[1])
    if eps is not None:
        kw["eps"] = float(eps)
    return AdamW(model.named_parameters(), schedule,
                 weight_decay=weight_decay, decay=no_decay_mask(model),
                 clip_norm=clip_norm, correct_bias=correct_bias,
                 grad_accum_steps=grad_accum_steps, **kw)
