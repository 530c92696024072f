"""The fine-tuning optimizers and their learning-rate schedules.

Counterpart of ``volta_tpu/optimization.py`` (which imports JAX and optax):
the schedules (:27-62), ``no_decay_mask`` (:66-115) on the port's parameter
names, AdamW with ``correct_bias=False`` (:119-172) and its reduced-
precision moments, RAdam / PlainRAdam (:182-244), per-parameter lr scales
(:248-289) and ``skip_disconnected`` (:292-321), assembled as
``build_optimizer`` (:325-365) nests them. The AdamW update is the optax
chain, step for step:

    g <- g * max_norm / max(||g||, max_norm)          clip_by_global_norm
    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    u <- m / (sqrt(v) + eps)                          (bias-corrected m, v
                                                       with correct_bias)
    u <- u + wd * p       where the mask decays p     add_decayed_weights,
                                                      from the pre-update p
    u <- -lr(count) * u,  count <- count + 1          scale_by_learning_rate
    u <- s * u            s: the parameter's lr scale scale_updates_by
    u <- 0  where g (clipped) is all zero             skip_disconnected
    p <- p + u

so the schedule is read at the number of updates already made: with warmup
the first step's lr is 0. Bias correction (and RAdam's rectification)
counts its own updates (``adam_count``, optax's ``ScaleByAdamState.count``
or JAX's ``_RAdamState.count``): a run resumed from the reference's tar
takes the schedule's position from its ``global_step`` and this count from
its moments' ``step`` (volta_tpu/checkpoint.py:535-575), which may differ.
``torch.optim.AdamW`` always corrects the bias and decays the post-update
parameter, so it is not this. With ``state_dtype`` bf16 the moments are
stored rounded: without bias correction both, updated in float32 and read
back as stored; with it only m, as optax's ``mu_dtype`` (b1 m in bf16, the
update from the float32 m, then m cast). The update runs as
``torch._foreach_*`` ops over all parameters at once and reads nothing back
to the host: ``skip_disconnected``'s mask is a device tensor multiplied in.

With ``grad_accum_steps`` K > 1 the chain sits inside ``optax.MultiSteps``
(:363-364): each call folds its gradients into their running mean,
acc <- acc + (g - acc) / (n + 1) as optax's ``use_grad_mean`` does, and
only every K-th call clips that mean and takes one update and one
schedule tick; the parameters are untouched in between. Parameters named
in ``frozen`` (``train_utils.apply_freeze``) have their gradient zeroed
before all of it, as ``optax.masked(optax.set_to_zero())`` ahead of the
chain does (volta_tpu/train_utils.py:199-207): they still take weight decay
and what momentum they have, unless ``skip_disconnected`` drops their
whole update.
"""

from __future__ import annotations

import math
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

    if pname == "bias" or pname in getattr(module, "RAW_PARAMS", ()):
        return pname
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




def lr_scales_from_loaded(model: nn.Module, loaded_paths: Iterable[str],
                          scale: float) -> Dict[str, float]:
    """Learning-rate multipliers by parameter name: ``scale`` for the
    parameters whose dotted Flax path is in ``loaded_paths`` (the
    importer's ``report["loaded"]``), 1.0 for the rest
    (volta_tpu/optimization.py:277-289): exactly the parameters that came
    from the checkpoint train slower."""
    loaded = set(loaded_paths)
    return {n: scale if ".".join(path) in loaded else 1.0
            for n, path in flax_paths(model).items()}


# --------------------------------------------------------------- optimizers
_TINY32 = float(np.finfo(np.float32).tiny)


def _pow32(base: float, t: int) -> np.float32:
    """float32(base) ** t as XLA computes ``base ** float32(t)`` on the
    CPU: the correctly rounded power, a result below float32's smallest
    normal flushed to 0 (equal to XLA's for t < 873 at 0.999, t < 90 at
    0.98; one ulp apart at a few larger t)."""
    r = np.float32(math.pow(float(np.float32(base)), float(t)))
    return np.float32(0.0) if abs(float(r)) < _TINY32 else r


def _bf16_round(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.bfloat16))


class AdamW:
    """AdamW over ``named_params`` with the optax chain of the module
    docstring. ``schedule`` maps the update count to the learning rate (a
    float is a constant); ``decay`` maps names to whether weight decay
    applies (all, if None); ``clip_norm`` enables the global-norm clip;
    ``grad_accum_steps`` K makes every K-th ``step`` an update of the mean
    gradient; ``frozen`` holds the indices of the parameters whose
    gradient is zeroed; ``state_dtype`` (``torch.bfloat16``) stores the
    moments at reduced precision; ``lr_scales`` maps names to multipliers
    of their final update; ``skip_disconnected`` zeroes the final update of
    a parameter whose gradient is all zero."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Union[Schedule, float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay: Optional[Dict[str, bool]] = None,
                 clip_norm: Optional[float] = None,
                 correct_bias: bool = False, grad_accum_steps: int = 1,
                 state_dtype: Optional[torch.dtype] = None,
                 lr_scales: Optional[Dict[str, float]] = None,
                 skip_disconnected: bool = False):
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
        self.state_dtype = state_dtype
        # reduced-precision moments live in one flat buffer each, viewed per
        # parameter, so that a step widens and stores each with one cast;
        # optax's mu_dtype casts only the first moment (with correct_bias)
        self._flat = {}
        self.mu = self._zeros("mu", state_dtype)
        self.nu = self._zeros("nu", None if correct_bias else state_dtype)
        # the parameters whose update is scaled, grouped by scale
        self.scaled = {}
        for i, n in enumerate(self.names):
            s = float((lr_scales or {}).get(n, 1.0))
            if s != 1.0:
                self.scaled.setdefault(s, []).append(i)
        self.skip_disconnected = skip_disconnected
        self.count = 0
        self.adam_count = 0
        self.frozen = set()
        self.accum_steps = int(grad_accum_steps)
        self.mini_step = 0  # gradients in the running mean, < accum_steps
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.accum_steps > 1 else None

    def _views(self, flat: torch.Tensor) -> list:
        return [v.view(p.shape) for v, p in zip(
            flat.split([p.numel() for p in self.params]), self.params)]

    def _zeros(self, key: str, dtype) -> list:
        """Zero moments like the parameters: float32 tensors, or with
        ``dtype`` views of one flat buffer ``self._flat[key]``."""
        if dtype is None:
            return [torch.zeros_like(p) for p in self.params]
        self._flat[key] = torch.zeros(
            sum(p.numel() for p in self.params), dtype=dtype,
            device=self.params[0].device)
        return self._views(self._flat[key])

    def _widened(self, key: str):
        """A float32 copy of the stored ``key`` moments (one cast of the
        flat buffer) and its per-parameter views."""
        flat = self._flat[key].float()
        return flat, self._views(flat)

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

    def _direction(self, grads):
        """The moments' update from ``grads``; returns the direction u,
        before decay and learning rate."""
        b1, b2 = self.b1, self.b2
        if self.state_dtype is None:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
            mu, nu = self.mu, self.nu
        elif self.correct_bias:
            # optax.scale_by_adam(mu_dtype=...): b1 rounded to the stored
            # dtype times the stored mu, a product that XLA keeps in
            # float32 (it drops the bf16 round trip), plus (1 - b1) g; the
            # update from that float32 mu, which is stored cast; nu float32
            mu_flat, mu = self._widened("mu")
            torch._foreach_mul_(mu, _bf16_round(b1))
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            self._flat["mu"].copy_(mu_flat)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
            nu = self.nu
        else:
            # _scale_by_adam_no_correction: the moments updated in float32,
            # stored rounded, and read as stored
            (mu_flat, mu), (nu_flat, nu) = (self._widened("mu"),
                                            self._widened("nu"))
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            g2 = torch._foreach_mul(grads, 1 - b2)
            torch._foreach_mul_(g2, grads)
            torch._foreach_add_(nu, g2)
            for key, flat in (("mu", mu_flat), ("nu", nu_flat)):
                self._flat[key].copy_(flat)
                flat.copy_(self._flat[key])  # read back as stored
        if self.correct_bias:
            t = self.adam_count + 1
            mu = torch._foreach_div(mu, 1 - b1 ** t)
            nu = torch._foreach_div(nu, 1 - b2 ** t)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu, denom)

    def _update(self, grads):
        """clip -> (skip_disconnected: the direction -> decay -> lr -> lr
        scales) on ``grads``; one schedule tick."""
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            factor = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
            grads = torch._foreach_mul(grads, factor)
        # 1 where the clipped gradient has a nonzero element: a device
        # tensor, never read on the host
        connected = list((torch.stack(torch._foreach_norm(grads, 1)) > 0)
                         .to(grads[0].dtype).unbind()) \
            if self.skip_disconnected else None
        upd = self._direction(grads)
        if self.decayed:
            torch._foreach_add_([upd[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed],
                                alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr())
        for s, idx in self.scaled.items():
            torch._foreach_mul_([upd[i] for i in idx], s)
        if connected is not None:
            torch._foreach_mul_(upd, connected)
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
        """Restore the counts, the moments (cast to the stored dtype) and,
        with K > 1, the running mean, each tensor by its parameter's name
        (a name missing from ``state`` raises)."""
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


class RAdam(AdamW):
    """Rectified Adam (volta_tpu/optimization.py:182-232; reference:
    volta/optimization.py:9-93) in AdamW's chain: float32 moments, and the
    step sizes of the update count t (``adam_count`` + 1, one a update)
    computed on the host in float32 as JAX computes them: rho = rho_inf -
    2 t b2^t / (1 - b2^t); where rho >= 5 (from step 6 at b2 = 0.999) the
    direction is rect sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps),
    eps outside the bias correction; before it m / (1 - b1^t), the
    SGD-style fallback (JAX's ``degenerated_to_sgd=True``). Decay applies
    in both. PlainRAdam is the same update
    (volta_tpu/optimization.py:235-244)."""

    def step_sizes(self, t: int):
        """(adaptive, the adaptive step size, the fallback's) at update t,
        float32 arithmetic in JAX's order."""
        f = np.float32
        b1, b2 = self.b1, self.b2
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b1t, b2t = _pow32(b1, t), _pow32(b2, t)
        rho = f(rho_inf) - f(2.0) * f(t) * b2t / (f(1.0) - b2t)
        num = (rho - f(4.0)) * (rho - f(2.0)) * f(rho_inf)
        den = max(f((rho_inf - 4) * (rho_inf - 2)) * rho, f(1e-12))
        rect = np.sqrt(max(num / den, f(0.0)))
        adapt = rect * np.sqrt(f(1.0) - b2t) / (f(1.0) - b1t)
        sgd = f(1.0) / (f(1.0) - b1t)
        return bool(rho >= f(5.0)), float(adapt), float(sgd)

    def _direction(self, grads):
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        adaptive, adapt, sgd = self.step_sizes(self.adam_count + 1)
        if not adaptive:
            return torch._foreach_mul(self.mu, sgd)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_mul(self.mu, adapt)
        torch._foreach_div_(upd, denom)
        return upd


def build_optimizer(name: str, schedule, model: nn.Module, *,
                    weight_decay: float = 0.01,
                    clip_norm: Optional[float] = None,
                    grad_accum_steps: int = 1, betas=None,
                    eps: Optional[float] = None,
                    correct_bias: bool = False, state_dtype=None,
                    lr_scales: Optional[Dict[str, float]] = None,
                    skip_disconnected_params: bool = False) -> AdamW:
    """The optimizer of ``volta_tpu.optimization.build_optimizer`` for
    ``model``'s parameters: clip -> skip_disconnected(optimizer (+ the
    no-decay mask) -> lr -> ``lr_scales``), inside the K-step accumulation
    with ``grad_accum_steps``. ``name`` is "adamw", "radam" or
    "plain_radam"; ``state_dtype`` and ``correct_bias`` apply to AdamW
    alone, as in JAX."""
    kw = dict(weight_decay=weight_decay, decay=no_decay_mask(model),
              clip_norm=clip_norm, grad_accum_steps=grad_accum_steps,
              lr_scales=lr_scales,
              skip_disconnected=skip_disconnected_params)
    if betas is not None:
        kw["b1"], kw["b2"] = float(betas[0]), float(betas[1])
    if eps is not None:
        kw["eps"] = float(eps)
    if name == "adamw":
        return AdamW(model.named_parameters(), schedule,
                     correct_bias=correct_bias, state_dtype=state_dtype,
                     **kw)
    if name in ("radam", "plain_radam"):
        if "eps" not in kw:
            kw["eps"] = 1e-8  # radam's own default
        return RAdam(model.named_parameters(), schedule, **kw)
    raise ValueError(f"unknown optimizer {name}")
