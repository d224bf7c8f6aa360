"""The optimizer factory of `dig_tpu/optim.py::create_optimizer`.

Every optimizer name of the JAX factory (`_inner_transform`,
`dig_tpu/optim.py:266-310`), its aliases and the ``lookahead_`` prefix,
with one update order for all of them (`dig_tpu/optim.py:313-405`):

1. clipping by the global norm, factor min(1, clip / (||g|| + 1e-6));
2. the inner transform: optax 0.2.6's update rule for the name;
3. ``p += -(lr * scale) * (u + wd * wd_ratio * p)`` on the decaying
   parameters (``-(lr * scale) * u`` on the rest), with lr and wd read from
   the schedule arrays at index min(count, len - 1); ``wd_ratio`` comes
   from AdamP's and SGDP's projection (`_projection`) and is 1 otherwise;
4. lookahead (k = 6, alpha = 0.5): every 6th update the slow copy moves
   half-way to the fast weights and the fast weights take its value.

Shared by every name, as the AdamW path has always had them:

* the no-decay set (`is_no_decay`: 1-D parameters, biases, norm scales,
  and by name the position / cls / mask tokens -- `encoder.mask_token` is
  3-D);
* layer-wise lr decay (`layer_scales`, reference optim_factory.py:32-54):
  lr * layer_decay ** (num_layers + 1 - layer id), with the ViT layer ids
  of `vit_layer_id`;
* frozen encoder layers (`frozen_encoder_mask`): lr scale 0, so they keep
  their values while their gradients still count in the global norm and
  their optimizer state still moves, as in the JAX package;
* every parameter is updated, a parameter without a gradient as with a
  zero one (optax steps every leaf);
* gradient accumulation (`update_freq` k > 1, optax `MultiSteps` in the
  JAX package): each call of `step` folds the gradients into a running
  mean, acc + (g - acc) / (n + 1) for the n-th of k; the k-th call clips
  that mean and updates, and the mean starts again from 0.  `count`, the
  schedules' index and the inner state count applied updates only;
* data parallel (a process group exists when the optimizer is built): the
  gradients are summed over the ranks and divided once by the world size
  (`parallel.dist.GradientReducer`) before the global norm and clipping:
  by the step, through `reduce_gradients`, right after its backward; under
  `update_freq` > 1, once, on the running mean, at the micro-step that
  applies it (the mean of the ranks' means is the global mean).

Two classes build them.  "adam" and "adamw" (and their fused aliases; one
transform in `dig_tpu`) without lookahead keep `AdamW`, on
`torch.optim.AdamW` with one parameter group per (decay, lr scale) pair,
whose checkpoint layout earlier port checkpoints hold.  Every other name
is `OptaxOptimizer`: optax's rules written out on `torch._foreach_*` ops,
its state in `state_dict()` / `load_state_dict()`.  The traps of optax's
rules that it keeps: "sgd" is Nesterov momentum; RMSProp starts its second
moment at 0 with eps inside the square root; RAdam's rectification only
from rho >= 5, the bias-corrected first moment below; NAdam's first moment
corrected at count + 1 and count; Adafactor factors a parameter only when
its two largest dims are >= 128 (decay 1 - (t + 1)^-0.8, epsilon 1e-30);
NovoGrad keeps one second moment per parameter, initialised to the first
gradient's squared norm; the trust ratio (LAMB, LARS) is 1 where ||p|| or
||u|| is 0; Lion takes the sign.  Scalars that optax computes in the
parameters' precision (bias corrections, RAdam's rho, Adafactor's decay)
are computed in it here too, and in float32 where optax or `dig_tpu`
fixes that type (Adafactor's decay, AdamP's and AdaHessian's counts, lr
and wd).

AdaHessian takes the Hessian diagonal as an explicit argument,
``step(hess_diag=...)``, which `hutchinson_hessian_diag` estimates; a step
without it raises `ValueError`, as the JAX transform does.  The CLIs' steps
do not wire it, in `dig_tpu` neither.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from dig_tpu_torch.parallel.dist import GradientReducer, is_distributed

NO_DECAY_NAMES = ("pos_embed", "cls_token", "mask_token")
_EMBED_NAMES = ("cls_token", "mask_token", "pos_embed", "patch_embed")

# name (after the last "_") -> the update rule of `dig_tpu/optim.py::_inner_transform`
RULES = {
    "sgd": "nesterov", "nesterov": "nesterov", "fusedsgd": "nesterov",
    "momentum": "momentum", "fusedmomentum": "momentum",
    "adam": "adam", "fusedadam": "adam", "adamw": "adam", "fusedadamw": "adam",
    "nadam": "nadam", "radam": "radam", "adadelta": "adadelta", "adafactor": "adafactor",
    "rmsprop": "rmsprop", "rmsproptf": "rmsprop", "lamb": "lamb", "fusedlamb": "lamb",
    "lars": "lars", "novograd": "novograd", "nvnovograd": "novograd",
    "fusednovograd": "novograd", "lion": "lion", "adamp": "adamp", "sgdp": "sgdp",
    "adahessian": "adahessian",
}
LOOKAHEAD_K, LOOKAHEAD_ALPHA = 6, 0.5  # timm Lookahead's defaults, as dig_tpu takes them


def is_no_decay(name: str, param: torch.Tensor) -> bool:
    return param.ndim <= 1 or any(tok in name for tok in NO_DECAY_NAMES)


def vit_layer_id(name: str, num_layers: int) -> int:
    """ViT depth index of a parameter for layer-wise lr decay
    (`dig_tpu/optim.py:43-55`; reference optim_factory.py:32-43): 0 for the
    embeddings, i + 1 for block i, num_layers - 1 for everything else; the
    `encoder.` prefix is stripped first."""
    if name.startswith("encoder."):
        name = name[len("encoder."):]
    parts = name.split(".")
    if parts[0] in _EMBED_NAMES:
        return 0
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return num_layers - 1


def layer_scales(names, layer_decay: float, num_layers: int) -> dict:
    """{name: lr multiplier layer_decay ** (num_layers + 1 - id)}
    (`dig_tpu/optim.py:58-66`)."""
    scales = [layer_decay ** (num_layers + 1 - i) for i in range(num_layers + 2)]
    return {n: scales[min(vit_layer_id(n, num_layers + 2), num_layers + 1)] for n in names}


def frozen_encoder_mask(num_frozen_layers: int) -> Callable[[str], bool]:
    """Predicate on parameter names: the encoder's embeddings and its first
    `num_frozen_layers` blocks (`dig_tpu/optim.py:69-86`; reference
    run_class_finetuning.py:500-516)."""

    def is_frozen(name: str) -> bool:
        if num_frozen_layers <= 0 or not name.startswith("encoder."):
            return False
        parts = name.split(".")
        if parts[1] in _EMBED_NAMES:
            return True
        return parts[1] == "blocks" and int(parts[2]) < num_frozen_layers

    return is_frozen


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (optax's `global_norm`)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class _Factory:
    """What every optimizer of the factory shares: the parameters and their
    names, lr scales and decay mask, the schedules, accumulation, the
    data-parallel reduction, clipping and the update count."""

    def __init__(self, named_params, lr_schedule, wd_schedule, clip_grad, layer_decay,
                 num_layers, frozen, update_freq):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.update_freq = int(update_freq)
        self.mini_step = 0  # gradients folded into `acc` since the last update
        self.acc = None
        self.lr = np.asarray(lr_schedule, np.float32)
        self.wd = None if wd_schedule is None else np.asarray(wd_schedule, np.float32)
        self.clip_grad = clip_grad
        self.count = 0
        self.reducer = GradientReducer(self.params) if is_distributed() else None
        scales = (layer_scales(self.names, layer_decay, num_layers)
                  if layer_decay < 1.0 else {})
        self.lr_scales = [0.0 if frozen is not None and frozen(n) else scales.get(n, 1.0)
                          for n in self.names]
        self.no_decay = [is_no_decay(n, p) for n, p in named]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def reduce_gradients(self):
        """Make every parameter's `.grad` the data-parallel gradient (a
        parameter without one takes the ranks' sum with zero), when the next
        `step` applies the gradients as they are (`update_freq` 1).  Does
        nothing alone, and under accumulation, where `step` reduces the
        running mean instead."""
        if self.reducer is None or self.update_freq > 1:
            return
        for p, g in zip(self.params, self.reducer.reduce([p.grad for p in self.params])):
            p.grad = g

    def _gradients(self):
        """The clipped gradients of an update, set as the parameters'
        `.grad`; None when this call only folds them into the running mean."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.update_freq > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.update_freq:
                return None
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            torch._foreach_zero_(self.acc)
            if self.reducer is not None:
                grads = self.reducer.reduce(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.clip_grad is not None:
            factor = torch.clamp(self.clip_grad / (global_norm(grads) + 1e-6), max=1.0)
            torch._foreach_mul_(grads, factor)
        return grads

    def _schedules(self):
        """(lr, wd) of this update, as float32 scalars."""
        i = min(self.count, len(self.lr) - 1)
        return self.lr[i], np.float32(0.0) if self.wd is None else self.wd[i]

    def state_dict(self) -> dict:
        """{"inner": the rule's state, "count"} and, under accumulation,
        the running mean and its count ("acc", "mini_step")."""
        out = {"inner": self._inner_state(), "count": int(self.count)}
        if self.acc is not None:
            out.update(acc=self.acc, mini_step=int(self.mini_step))
        return out

    def load_state_dict(self, saved: dict) -> None:
        """Put back what `state_dict` gave; the hyper-parameters stay the
        ones this optimizer was built with."""
        self._load_inner_state(saved["inner"])
        self.count = int(saved["count"])
        if "acc" in saved:
            device = self.params[0].device
            self.acc = [a.to(device) for a in saved["acc"]]
            self.mini_step = int(saved["mini_step"])


class AdamW(_Factory):
    """The adam / adamw path: `torch.optim.AdamW` with one group per
    (decay, lr scale) pair.  Its bias-corrected moments with eps outside the
    square root, m / bc1 / (sqrt(v) / sqrt(bc2) + eps), are optax's
    m_hat / (sqrt(v_hat) + eps); its decay p *= 1 - lr * wd is the decoupled
    -lr * wd * p."""

    def __init__(self, named_params, lr_schedule, wd_schedule=None, betas=(0.9, 0.999),
                 eps: float = 1e-8, clip_grad: Optional[float] = None, layer_decay: float = 1.0,
                 num_layers: int = 12, frozen: Optional[Callable[[str], bool]] = None,
                 update_freq: int = 1):
        super().__init__(named_params, lr_schedule, wd_schedule, clip_grad, layer_decay,
                         num_layers, frozen, update_freq)
        groups = {}  # (no decay, lr scale) -> params; decaying groups first
        for p, nd, scale in zip(self.params, self.no_decay, self.lr_scales):
            groups.setdefault((nd, -scale), []).append(p)
        self.inner = torch.optim.AdamW(
            [{"params": ps, "no_decay": key[0], "lr_scale": -key[1]}
             for key, ps in sorted(groups.items())],
            lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)

    def step(self) -> bool:
        """Take the parameters' `.grad`s: an update, or with `update_freq`
        > 1 one more gradient into the running mean and an update on the
        k-th.  Returns whether the parameters were updated."""
        if self._gradients() is None:
            return False
        lr, wd = self._schedules()
        for group in self.inner.param_groups:
            group["lr"] = float(lr * np.float32(group["lr_scale"]))  # float32, as in dig_tpu
            group["weight_decay"] = 0.0 if group["no_decay"] else float(wd)
        self.inner.step()
        self.count += 1
        return True

    def _inner_state(self):
        return self.inner.state_dict()

    def _load_inner_state(self, saved):
        groups = self.inner.state_dict()["param_groups"]
        if [len(g["params"]) for g in saved["param_groups"]] != [len(g["params"]) for g in groups]:
            raise ValueError("the checkpoint's optimizer groups its parameters differently from "
                             "this run's (another model, layer decay or frozen layers)")
        self.inner.load_state_dict({"state": saved["state"], "param_groups": groups})


def _factored_dims(shape, min_dim: int = 128):
    """optax's `_factored_dims`: the two largest axes (np.argsort's order)
    when the second largest is >= `min_dim`, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _projection(p, g, u, delta: float, wd_ratio: float, eps: float):
    """AdamP / SGDP's tangent-space projection (`dig_tpu/optim.py:116-145`):
    where the parameter looks scale-invariant under the channel view (else
    the layer view), the radial part of `u` is removed and the weight decay
    scaled by `wd_ratio`.  Both views are computed and selected on the
    device, with no wait for it.  Returns (u, ratio or None for 1)."""
    if p.dim() < 2:
        return u, None

    def view(rows):
        pv, gv, uv = p.reshape(rows, -1), g.reshape(rows, -1), u.reshape(rows, -1)
        pn = torch.linalg.vector_norm(pv, dim=1)
        gn = torch.linalg.vector_norm(gv, dim=1)
        cos = (pv * gv).sum(dim=1).abs() / (pn * gn + eps)
        hit = cos.max() < delta / math.sqrt(pv.shape[1])
        p_n = pv / (pn[:, None] + eps)
        return hit, (uv - p_n * (p_n * uv).sum(dim=1, keepdim=True)).reshape(u.shape)

    hit_c, proj_c = view(p.shape[0])
    hit_l, proj_l = view(1)
    out = torch.where(hit_c, proj_c, torch.where(hit_l, proj_l, u))
    ratio = torch.where(hit_c | hit_l,
                        torch.full((), wd_ratio, dtype=torch.float32, device=p.device),
                        torch.ones((), dtype=torch.float32, device=p.device))
    return out, ratio


class OptaxOptimizer(_Factory):
    """Every optimizer of the factory but the AdamW path: `rule` is a value
    of `RULES`; `lookahead` wraps it.  The state is a dict of per-parameter
    tensor lists (`state_dict()["inner"]["state"]`)."""

    def __init__(self, rule: str, named_params, lr_schedule, wd_schedule=None,
                 betas=(0.9, 0.999), eps: float = 1e-8, momentum: float = 0.9,
                 clip_grad: Optional[float] = None, layer_decay: float = 1.0,
                 num_layers: int = 12, frozen: Optional[Callable[[str], bool]] = None,
                 update_freq: int = 1, lookahead: bool = False):
        super().__init__(named_params, lr_schedule, wd_schedule, clip_grad, layer_decay,
                         num_layers, frozen, update_freq)
        self.rule, self.lookahead = rule, lookahead
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.momentum = float(eps), float(momentum)
        # optax computes its scalars in the parameters' precision
        self.np_dtype = np.float64 if self.params[0].dtype == torch.float64 else np.float32
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        names = {"nesterov": ("trace",), "momentum": ("trace",), "lars": ("trace",),
                 "adam": ("mu", "nu"), "nadam": ("mu", "nu"), "radam": ("mu", "nu"),
                 "lamb": ("mu", "nu"), "adamp": ("mu", "nu"), "adahessian": ("mu", "nu"),
                 "adadelta": ("e_g", "e_x"), "rmsprop": ("nu",), "lion": ("mu",),
                 "sgdp": ("buf",), "novograd": ("mu",), "adafactor": ()}[rule]
        self.state = {k: zeros() for k in names}
        if rule == "novograd":
            self.state["nu"] = [torch.zeros((), dtype=p.dtype, device=p.device)
                                for p in self.params]
        if rule == "adafactor":
            self.state.update(v_row=[], v_col=[], v=[])
            for p in self.params:
                dims = _factored_dims(p.shape)
                one = torch.zeros((1,), dtype=p.dtype, device=p.device)
                if dims is None:
                    self.state["v_row"].append(one)
                    self.state["v_col"].append(one.clone())
                    self.state["v"].append(torch.zeros_like(p))
                else:
                    d1, d0 = dims
                    self.state["v_row"].append(p.new_zeros(np.delete(p.shape, d0).tolist()))
                    self.state["v_col"].append(p.new_zeros(np.delete(p.shape, d1).tolist()))
                    self.state["v"].append(one)
        if lookahead:
            self.state["slow"] = [p.detach().clone() for p in self.params]

    def _s(self, x):
        """A scalar in the parameters' precision (numpy keeps Python floats weak)."""
        return self.np_dtype(x)

    def _bias_correction(self, decay: float, count: int) -> float:
        return float(1 - self._s(decay) ** self._s(count))

    @staticmethod
    def _ema(g, t, decay: float):
        """optax's `update_moment`, (1 - decay) * g + decay * t, rounded as it is."""
        return torch._foreach_add(torch._foreach_mul(g, 1.0 - decay), torch._foreach_mul(t, decay))

    def _adam_moments(self, g):
        st = self.state
        st["mu"] = self._ema(g, st["mu"], self.b1)
        st["nu"] = self._ema(torch._foreach_mul(g, g), st["nu"], self.b2)
        return st["mu"], st["nu"]

    def _adam_direction(self, mu_hat, nu, c):
        nu_hat = torch._foreach_div(nu, self._bias_correction(self.b2, c))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(mu_hat, den)

    def _trust_ratio(self, u):
        """optax's `scale_by_trust_ratio`: u * ||p|| / ||u||, 1 where either is 0."""
        pn = torch.stack(torch._foreach_norm(self.params))
        un = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
        return torch._foreach_mul(u, list(ratio.unbind()))

    def _inner(self, g, hess_diag):
        """(updates, per-parameter wd ratios or None) of the rule."""
        st, c = self.state, self.count + 1  # optax's count after its increment
        rule, m = self.rule, self.momentum
        if rule in ("nesterov", "momentum", "lars"):
            st["trace"] = torch._foreach_add(g, torch._foreach_mul(st["trace"], m))
            u = (torch._foreach_add(g, torch._foreach_mul(st["trace"], m))
                 if rule == "nesterov" else list(st["trace"]))
            return (self._trust_ratio(u) if rule == "lars" else u), None
        if rule in ("adam", "lamb"):
            mu, nu = self._adam_moments(g)
            u = self._adam_direction(torch._foreach_div(mu, self._bias_correction(self.b1, c)),
                                     nu, c)
            return (self._trust_ratio(u) if rule == "lamb" else u), None
        if rule == "nadam":
            mu, nu = self._adam_moments(g)
            mu_hat = torch._foreach_add(
                torch._foreach_mul(torch._foreach_div(mu, self._bias_correction(self.b1, c + 1)),
                                   self.b1),
                torch._foreach_mul(torch._foreach_div(g, self._bias_correction(self.b1, c)),
                                   1.0 - self.b1))
            return self._adam_direction(mu_hat, nu, c), None
        if rule == "radam":
            mu, nu = self._adam_moments(g)
            mu_hat = torch._foreach_div(mu, self._bias_correction(self.b1, c))
            s = self._s
            ro_inf = 2.0 / (1.0 - self.b2) - 1.0
            b2t = s(self.b2) ** s(c)
            ro = ro_inf - 2 * s(c) * b2t / (1 - b2t)
            if ro < 5.0:  # optax's threshold: no rectification yet
                return list(mu_hat), None
            r = float(np.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0)
                                                                  * ro)))
            return self._adam_direction(torch._foreach_mul(mu_hat, r), nu, c), None
        if rule == "adadelta":
            rho, eps = 0.9, self.eps
            st["e_g"] = self._ema(torch._foreach_mul(g, g), st["e_g"], rho)
            num = torch._foreach_sqrt(torch._foreach_add(st["e_x"], eps))
            den = torch._foreach_sqrt(torch._foreach_add(st["e_g"], eps))
            u = torch._foreach_mul(torch._foreach_div(num, den), g)
            st["e_x"] = self._ema(torch._foreach_mul(u, u), st["e_x"], rho)
            return u, None
        if rule == "rmsprop":
            st["nu"] = self._ema(torch._foreach_mul(g, g), st["nu"], 0.9)
            return torch._foreach_mul(torch._foreach_rsqrt(
                torch._foreach_add(st["nu"], self.eps)), g), None
        if rule == "lion":
            u = [torch.sign(t) for t in torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                                                           torch._foreach_mul(st["mu"], self.b1))]
            st["mu"] = self._ema(g, st["mu"], self.b2)
            return u, None
        if rule == "novograd":
            sq = [torch.linalg.vector_norm(x) ** 2 for x in g]
            st["nu"] = sq if c == 1 else self._ema(sq, st["nu"], self.b2)
            den = torch._foreach_sqrt(st["nu"])
            torch._foreach_add_(den, self.eps)
            step = torch._foreach_div(g, den)
            st["mu"] = step if c == 1 else torch._foreach_add(
                torch._foreach_mul(st["mu"], self.b1), step)
            return list(st["mu"]), None
        if rule == "adafactor":
            return self._adafactor(g), None
        if rule == "adamp":
            b1, b2 = self.b1, self.b2
            st["mu"] = torch._foreach_add(torch._foreach_mul(st["mu"], b1),
                                          torch._foreach_mul(g, 1 - b1))
            st["nu"] = torch._foreach_add(torch._foreach_mul(st["nu"], b2), torch._foreach_mul(
                torch._foreach_mul(g, 1 - b2), g))
            s = np.float32  # dig_tpu's AdamP counts in float32 whatever the parameters' type
            bc1, bc2 = 1.0 - s(b1) ** s(c), 1.0 - s(b2) ** s(c)
            den = torch._foreach_div(torch._foreach_sqrt(st["nu"]), float(np.sqrt(bc2)))
            torch._foreach_add_(den, self.eps)
            num = torch._foreach_add(torch._foreach_mul(st["mu"], b1),
                                     torch._foreach_mul(g, 1 - b1))
            u = torch._foreach_div(torch._foreach_div(num, den), float(bc1))
            return self._project(g, u, 0.1, 0.01, self.eps, 1.0)
        if rule == "sgdp":
            st["buf"] = torch._foreach_add(torch._foreach_mul(st["buf"], m), g)
            u = torch._foreach_add(g, torch._foreach_mul(st["buf"], m))
            return self._project(g, u, 0.1, 0.1, 1e-8, 1.0 - m)
        if rule == "adahessian":
            if hess_diag is None:
                raise ValueError(
                    "adahessian needs the Hessian diagonal: call step(hess_diag=...) with "
                    "dig_tpu_torch.optim.hutchinson_hessian_diag(grad_fn, params, generator)")
            b1, b2 = self.b1, self.b2
            st["mu"] = torch._foreach_add(torch._foreach_mul(st["mu"], b1),
                                          torch._foreach_mul(g, 1 - b1))
            st["nu"] = torch._foreach_add(torch._foreach_mul(st["nu"], b2), torch._foreach_mul(
                torch._foreach_mul(list(hess_diag), 1 - b2), list(hess_diag)))
            bc1, bc2 = (float(1.0 - np.float32(b) ** np.float32(c)) for b in (b1, b2))
            mu_hat = torch._foreach_div(st["mu"], bc1)  # float32 counts, as in dig_tpu
            den = torch._foreach_sqrt(torch._foreach_div(st["nu"], bc2))
            torch._foreach_add_(den, self.eps)
            return torch._foreach_div(mu_hat, den), None
        raise ValueError(f"Invalid optimizer rule '{rule}'")

    def _project(self, g, u, delta, wd_ratio, eps, ratio_div):
        """`_projection` on every parameter; the ratio divided by
        `ratio_div` (SGDP's 1 - momentum), as float32 arithmetic gives it."""
        out, ratios = [], []
        for p, gi, ui in zip(self.params, g, u):
            o, r = _projection(p.detach(), gi, ui, delta, wd_ratio, eps)
            out.append(o)
            ratios.append(r / ratio_div if r is not None else
                          float(np.float32(1.0) / np.float32(ratio_div)))
        return out, ratios

    def _adafactor(self, g):
        """optax's `scale_by_factored_rms()` at its defaults."""
        st = self.state
        t = np.float32(self.count + 1)  # optax's `_decay_rate_pow` is float32
        decay_t = 1.0 - t ** np.float32(-0.8)
        decay, keep = float(decay_t), float(1.0 - decay_t)
        out = []
        for i, (p, gi) in enumerate(zip(self.params, g)):
            dims = _factored_dims(p.shape)
            sq = gi * gi + 1e-30
            if dims is None:
                st["v"][i] = decay * st["v"][i] + keep * sq
                out.append(gi * st["v"][i] ** -0.5)
                continue
            d1, d0 = dims
            st["v_row"][i] = decay * st["v_row"][i] + keep * sq.mean(dim=d0)
            st["v_col"][i] = decay * st["v_col"][i] + keep * sq.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = st["v_row"][i].mean(dim=reduced_d1, keepdim=True)
            row_factor = (st["v_row"][i] / row_col_mean) ** -0.5
            col_factor = st["v_col"][i] ** -0.5
            out.append(gi * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
        return out

    @torch.no_grad()
    def step(self, hess_diag=None) -> bool:
        """As `AdamW.step`; `hess_diag` (a list in the order of
        `self.params`) is AdaHessian's Hessian diagonal."""
        grads = self._gradients()
        if grads is None:
            return False
        params = [p.detach() for p in self.params]
        u, ratios = self._inner(grads, hess_diag)
        u = list(u)
        lr, wd = self._schedules()
        for i, p in enumerate(params):  # lr, wd and the ratios are float32, as in dig_tpu
            upd = u[i]
            if not self.no_decay[i]:
                r = 1.0 if ratios is None else ratios[i]
                coef = r * float(wd) if torch.is_tensor(r) else float(wd * np.float32(r))
                upd = upd + coef * p
            u[i] = upd * float(-(lr * np.float32(self.lr_scales[i])))
        if self.lookahead:
            fast = torch._foreach_add(params, u)
            if (self.count + 1) % LOOKAHEAD_K == 0:
                slow = self.state["slow"]
                torch._foreach_add_(slow, torch._foreach_mul(torch._foreach_sub(fast, slow),
                                                             LOOKAHEAD_ALPHA))
                fast = slow
            u = torch._foreach_sub(fast, params)
        torch._foreach_add_(params, u)
        self.count += 1
        return True

    def _inner_state(self):
        return {"rule": self.rule, "state": {k: list(v) for k, v in self.state.items()}}

    def _load_inner_state(self, saved):
        if saved.get("rule") != self.rule or sorted(saved["state"]) != sorted(self.state):
            raise ValueError(f"the checkpoint's optimizer state is {saved.get('rule')!r}'s, "
                             f"this run's optimizer is {self.rule!r}")
        for k, tensors in saved["state"].items():
            if len(tensors) != len(self.params):
                raise ValueError("the checkpoint's optimizer holds state for "
                                 f"{len(tensors)} parameters, this run has {len(self.params)}")
            self.state[k] = [t.to(p.device) for t, p in zip(tensors, self.params)]


def create_optimizer(opt_name: str, named_params, lr_schedule, wd_schedule=None,
                     betas=(0.9, 0.999), eps: float = 1e-8, momentum: float = 0.9,
                     clip_grad: Optional[float] = None, layer_decay: float = 1.0,
                     num_layers: int = 12, frozen: Optional[Callable[[str], bool]] = None,
                     update_freq: int = 1):
    """`dig_tpu.optim.create_optimizer` for any of its names: the name
    after the last "_" picks the rule (an unknown one raises `ValueError`,
    as there), a ``lookahead_`` prefix wraps it.  `frozen` is a predicate
    on parameter names (`frozen_encoder_mask`); `update_freq` > 1
    accumulates as optax `MultiSteps` wrapped around it does
    (`dig_tpu/cli/run_finetune.py:330-334`)."""
    rule, lookahead = parse_optimizer_name(opt_name)
    if rule == "adam" and not lookahead:
        return AdamW(named_params, lr_schedule, wd_schedule, betas, eps, clip_grad, layer_decay,
                     num_layers, frozen, update_freq)
    return OptaxOptimizer(rule, named_params, lr_schedule, wd_schedule, betas, eps, momentum,
                          clip_grad, layer_decay, num_layers, frozen, update_freq, lookahead)


def parse_optimizer_name(opt_name: str):
    """(rule, lookahead) of an optimizer name, read as `dig_tpu` reads it:
    the part after the last "_", lower case, picks the rule, and a
    ``lookahead_`` prefix wraps it; `ValueError` for a name it does not know."""
    name = opt_name.lower().split("_")[-1]
    if name not in RULES:
        raise ValueError(f"Invalid optimizer '{opt_name}'")
    return RULES[name], opt_name.lower().startswith("lookahead_")


def hutchinson_hessian_diag(grad_fn, params, generator: torch.Generator):
    """One Rademacher sample of the Hessian diagonal, z * (H z), with H z
    the forward-mode derivative of `grad_fn` (a function of `params` that
    returns the loss's gradient, e.g. `torch.func.grad(loss)`) along z
    (`dig_tpu/optim.py:252-263`).  `params` is a list or dict of tensors;
    z is drawn from `generator`, one tensor after another."""
    items = list(params.items()) if isinstance(params, dict) else list(enumerate(params))
    z = [(torch.randint(0, 2, t.shape, generator=generator, device=t.device) * 2 - 1).to(t.dtype)
         for _, t in items]
    if isinstance(params, dict):
        z = dict(zip(params, z))
    _, hz = torch.func.jvp(grad_fn, (params,), (z,))
    if isinstance(params, dict):
        return {k: z[k] * hz[k] for k in params}
    return [zi * hi for zi, hi in zip(z, hz)]
