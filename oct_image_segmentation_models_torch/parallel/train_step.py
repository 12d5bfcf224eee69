"""Train and eval steps and the optimizers, counterpart of the JAX
package's ``parallel/train_step.py``.

- :class:`TrainState` holds the module (its parameters and BatchNorm
  statistics), the optimizer and the step count.
- :func:`make_train_step` returns ``train_step(state, images, labels,
  generator[, choices]) -> (state, loss, metric)``: one forward in train
  mode (batch statistics, dropout from ``generator``), the backward, one
  optimizer step. ``state`` is updated in place and returned; loss and
  metric are 0-d tensors on the device, never read back inside the step.
- :func:`make_eval_step` returns ``eval_step(state, images, labels) ->
  (loss, metric)``, the eval-mode forward.
- Both steps run under the module's precision context
  (:func:`.._device.precision`, the backward included), whatever the
  caller's TF32 settings: full float32, or for a bfloat16 module a
  bfloat16 conv stack that accumulates in float32 with the head, the loss
  and the metric in float32.
- The optimizers compute optax 0.2.6's update rules (the JAX package's),
  with the Keras defaults the JAX package maps onto them (epsilon 1e-7,
  learning rate 1e-3, SGD's 0.01, RMSprop's ``rho``). ``torch.optim``'s
  own rules differ from optax's for adagrad (optax starts the accumulator
  at 0.1, eps 1e-7), adamax (eps outside the max), nadam (optax's
  Nesterov Adam) and adamw (default weight decay 1e-4, not 1e-2), and
  round differently for the rest, so every rule here follows the optax
  source op for op.

Data parallelism over a :class:`.mesh.Mesh` (one process per device),
as JAX's ``impl`` picks it:

- ``"shard_map"`` (``"auto"`` on more than one rank): each rank steps on
  its own rows with per-replica BatchNorm; DDP averages the gradients over
  the world (``broadcast_buffers=False``: DDP's default would overwrite
  every rank's running statistics with rank 0's); the loss, the metric
  and the new running statistics are then averaged over the world (JAX's
  ``pmean``); each rank draws dropout from its own generator (JAX folds
  the device index into the key). The eval step averages its loss and
  metric likewise.
- ``"spmd"`` (``"auto"`` on one rank) is the one-device step; on more
  than one rank, as JAX defines it, the one-device step on the global
  batch, every rank's rows concatenated in rank order. Inside the step
  (``parallel.mesh.global_batch``) every BatchNorm sums its statistics
  over the world, and dropout and the device augmentation draw the global
  batch's randoms from the stream every rank shares (the run's seed on
  every rank) and keep this rank's rows. The outputs and labels are
  gathered (``parallel.mesh.gather_rows``), and the loss and the metric
  are the registry's functions of the global batch, so Dice sums run over
  every rank's rows. Each rank's gradient then comes back as the world
  size times its rows' share of the global gradient (the gather's and the
  statistics' all-reduces sum in the backward), and the mean over the
  world is the global gradient. Every rank ends a step with equal
  parameters, statistics and optimizer state. The eval step takes the
  global batch's loss and metric likewise.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .._device import compute_dtype, module_dtype, precision
from ..ops.bn_refresh import _stat_buffers
from . import mesh as mesh_lib

def _resolve_impl(mesh, impl: str) -> str:
    """"one" (the one-device step), "global" (the one-device step on the
    world's global batch) or "replica" (per replica over ``mesh``)."""
    if impl not in ("auto", "spmd", "shard_map"):
        raise ValueError(f"unknown train step impl: {impl}")
    if mesh is None:
        if impl == "shard_map":
            raise ValueError(
                "impl='shard_map' needs a mesh: initialise a process group and "
                "pass parallel.mesh.create_mesh()"
            )
        return "one"
    if not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if impl == "auto":
        impl = "spmd" if mesh.world == 1 else "shard_map"
    if impl == "spmd":
        return "one" if mesh.world == 1 else "global"
    return "replica"


@dataclass
class TrainState:
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(module: torch.nn.Module, tx: Callable, mesh=None) -> TrainState:
    """A fresh state: ``tx`` (from :func:`build_optimizer`) is called on the
    module's parameters. With a mesh of more than one rank, every rank
    takes rank 0's parameters and statistics, as JAX replicates the state
    over the mesh."""
    if mesh is not None and mesh.world > 1:
        mesh_lib.broadcast_module(module)
    return TrainState(module=module, optimizer=tx(list(module.parameters())), step=0)


def make_train_step(
    module: torch.nn.Module,
    loss_fn: Callable,
    metric_fn: Callable,
    mesh=None,
    impl: str = "auto",
    input_transform: Callable = None,
) -> Callable:
    """Returns ``train_step(state, images, labels, generator[, choices])
    -> (state, loss, metric)`` for ``module`` (the module ``state`` holds).

    ``input_transform(generator, images, labels, choices) -> (images,
    labels)`` is optional device-side batch preparation (augmentation and
    the model's preprocess) run inside the step; with it, the step takes
    the generator's per-sample ``choices``. The augmentation draws from
    ``generator`` first, then the dropout mask. ``impl`` and ``mesh`` as
    in the module docstring: over a mesh each rank passes its own rows and
    generator, and gets the world's mean loss and metric ("shard_map") or
    the global batch's ("spmd", where every rank's generator must be in
    the same state).

    The step's keyword ``on_phase(name)``, when given, is called at the end
    of each of its phases, "forward" (the forward, loss and metric),
    "backward" (with the averaging over the world) and "optimizer": a hook
    to time the step's split, e.g. by recording a CUDA event."""
    kind = _resolve_impl(mesh, impl)
    forward = module
    step_dtype = module_dtype(module)
    stats = list(_stat_buffers(module).values())
    params = [p for p in module.parameters() if p.requires_grad]
    if kind == "replica":
        from torch.nn.parallel import DistributedDataParallel

        forward = DistributedDataParallel(
            module,
            device_ids=[mesh.device] if mesh.device.type == "cuda" else None,
            broadcast_buffers=False,
        )

    def train_step(state: TrainState, images, labels, generator, choices=None, *, on_phase=None):
        mark = on_phase or (lambda name: None)
        with precision(step_dtype), _global_batch(kind, mesh):
            forward.train()
            if input_transform is not None:
                images, labels = input_transform(generator, images, labels, choices)
            out = forward(images, generator=generator)
            if kind == "global":
                out, labels = mesh_lib.gather_rows(out, mesh), mesh_lib.gather_rows(labels, mesh)
            loss = loss_fn(labels, out)
            with torch.no_grad():
                metric = metric_fn(labels, out)
            mark("forward")
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = loss.detach()
            with torch.no_grad():
                if kind == "replica":
                    *means, loss, metric = mesh_lib.mean_over_world(stats + [loss, metric], mesh)
                    for buf, mean in zip(stats, means):
                        buf.copy_(mean)
                elif kind == "global":
                    # Every rank's loss is the global loss, so each rank's
                    # gradient is the world size times its rows' share:
                    # the mean over the world is the global gradient.
                    grads = [p.grad for p in params]
                    for grad, mean in zip(grads, mesh_lib.mean_over_world(grads, mesh)):
                        grad.copy_(mean)
            mark("backward")
            state.optimizer.step()
            mark("optimizer")
        state.step += 1
        return state, loss, metric

    return train_step


def _global_batch(kind: str, mesh):
    """The global-batch context of an spmd step over several ranks."""
    return mesh_lib.global_batch(mesh) if kind == "global" else contextlib.nullcontext()


def make_eval_step(
    module: torch.nn.Module,
    loss_fn: Callable,
    metric_fn: Callable,
    mesh=None,
    impl: str = "auto",
) -> Callable:
    """Returns ``eval_step(state, images, labels) -> (loss, metric)``, the
    eval-mode forward (running BatchNorm statistics, no dropout) under the
    module's precision context; over a mesh, on each rank's rows, with the
    world's mean loss and metric ("shard_map") or the loss and metric of
    the global batch ("spmd")."""
    kind = _resolve_impl(mesh, impl)
    step_dtype = module_dtype(module)

    def eval_step(state: TrainState, images, labels):
        module.eval()
        with torch.no_grad(), precision(step_dtype):
            out = module(images)
            if kind == "global":
                out, labels = mesh_lib.gather_rows(out, mesh), mesh_lib.gather_rows(labels, mesh)
            loss, metric = loss_fn(labels, out), metric_fn(labels, out)
            if kind == "replica":
                loss, metric = mesh_lib.mean_over_world([loss, metric], mesh)
            return loss, metric

    return eval_step


def batch_stats(module: torch.nn.Module) -> dict:
    """The BatchNorm running statistics, ``{buffer name: tensor}`` (copies)."""
    return {name: buf.detach().clone() for name, buf in _stat_buffers(module).items()}


def load_batch_stats(module: torch.nn.Module, stats: dict) -> None:
    """Copy ``stats`` (as :func:`batch_stats` gives them) into ``module``."""
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for name, value in stats.items():
            buffers[name].copy_(value)


# --- optax 0.2.6's update rules -------------------------------------------


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX holds a weak-typed Python scalar."""
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _decayed(slots, decay):
    """``decay * t`` per tensor, in the tensor's dtype. A bfloat16 slot
    (optax's ``mu_dtype``, ``accumulator_dtype``) is multiplied by
    ``decay`` rounded to bfloat16 and the product rounded to it, as JAX
    takes a weak-typed Python scalar into a bfloat16 product; then it
    promotes to float32 in the sum with the float32 gradient."""
    if all(t.dtype == torch.float32 for t in slots):
        return torch._foreach_mul(slots, decay)
    factor = {d: torch.tensor(decay, dtype=d).item() for d in {t.dtype for t in slots}}
    return [t * factor[t.dtype] for t in slots]


def _moment(grads, moments, decay, order):
    """``(1 - decay) * g**order + decay * m`` per tensor."""
    g = torch._foreach_mul(grads, grads) if order == 2 else grads
    return torch._foreach_add(
        torch._foreach_mul(g, _f32(1 - decay)), _decayed(moments, decay)
    )


def _trace(updates, traces, decay, nesterov):
    """optax ``trace``: ``t' = g + decay * t``; returns (updates, t')."""
    new = torch._foreach_add(updates, _decayed(traces, decay))
    if nesterov:
        return torch._foreach_add(updates, torch._foreach_mul(new, decay)), new
    return new, new


def _adam(h, params, grads, st, count):
    b1, b2 = h["b1"], h["b2"]
    st["mu"] = _moment(grads, st["mu"], b1, 1)
    st["nu"] = _moment(grads, st["nu"], b2, 2)
    count_inc = count + 1
    if h["nesterov"]:
        mu_hat = torch._foreach_add(
            torch._foreach_mul(
                torch._foreach_div(st["mu"], _bias_correction(b1, count_inc + 1)), b1
            ),
            torch._foreach_mul(
                torch._foreach_div(grads, _bias_correction(b1, count_inc)), _f32(1 - b1)
            ),
        )
    else:
        mu_hat = torch._foreach_div(st["mu"], _bias_correction(b1, count_inc))
    nu_hat = torch._foreach_div(st["nu"], _bias_correction(b2, count_inc))
    denom = torch._foreach_sqrt(torch._foreach_add(nu_hat, h["eps_root"]))
    updates = torch._foreach_div(mu_hat, torch._foreach_add(denom, h["eps"]))
    if h.get("weight_decay") is not None:
        updates = torch._foreach_add(
            updates, torch._foreach_mul(params, h["weight_decay"])
        )
    return updates


def _sgd(h, params, grads, st, count):
    if h["momentum"] is None:
        return grads
    updates, st["trace"] = _trace(grads, st["trace"], h["momentum"], h["nesterov"])
    return updates


def _rmsprop(h, params, grads, st, count):
    decay, eps = h["decay"], h["eps"]
    st["nu"] = _moment(grads, st["nu"], decay, 2)
    if h["centered"]:
        st["mu"] = _moment(grads, st["mu"], decay, 1)
    nu_hat, mu_hat = st["nu"], st.get("mu")
    if h["bias_correction"]:
        bc = _bias_correction(decay, count + 1)
        nu_hat = torch._foreach_div(nu_hat, bc)
        if h["centered"]:
            mu_hat = torch._foreach_div(mu_hat, bc)
    if h["centered"]:
        nu_hat = torch._foreach_sub(nu_hat, torch._foreach_mul(mu_hat, mu_hat))
    if h["eps_in_sqrt"]:
        scaling = torch._foreach_rsqrt(torch._foreach_add(nu_hat, eps))
    else:
        scaling = torch._foreach_reciprocal(
            torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        )
    return torch._foreach_mul(scaling, grads)


def _adagrad(h, params, grads, st, count):
    st["sum_of_squares"] = torch._foreach_add(
        torch._foreach_mul(grads, grads), st["sum_of_squares"]
    )
    inv = [
        torch.where(s > 0, torch.rsqrt(s + h["eps"]), torch.zeros((), device=s.device))
        for s in st["sum_of_squares"]
    ]
    return torch._foreach_mul(inv, grads)


def _adamax(h, params, grads, st, count):
    b1, b2 = h["b1"], h["b2"]
    st["mu"] = _moment(grads, st["mu"], b1, 1)
    st["nu"] = [
        torch.maximum(g.abs() + h["eps"], b2 * n) for g, n in zip(grads, st["nu"])
    ]
    mu_hat = torch._foreach_div(st["mu"], _bias_correction(b1, count + 1))
    return torch._foreach_div(mu_hat, st["nu"])


# rule -> the state slot whose dtype a hyper-parameter sets
_SLOT_DTYPES = {"adam": ("mu", "mu_dtype"), "sgd": ("trace", "accumulator_dtype")}
# rule -> (update function, {state slot: initial value key or constant})
_RULES = {
    "adam": (_adam, {"mu": 0.0, "nu": 0.0}),
    "sgd": (_sgd, {"trace": 0.0}),
    "rmsprop": (_rmsprop, {"nu": "initial_scale", "mu": 0.0, "trace": 0.0}),
    "adagrad": (_adagrad, {"sum_of_squares": "initial_accumulator_value"}),
    "adamax": (_adamax, {"mu": 0.0, "nu": 0.0}),
}


class OptaxRule(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` computing one of optax 0.2.6's update
    rules (``rule`` in ``adam`` (with ``nesterov`` and ``weight_decay``:
    nadam, adamw), ``sgd``, ``rmsprop``, ``adagrad``, ``adamax``), the
    optax state kept per parameter. ``learning_rate`` may be a schedule
    ``count -> rate``, called with the update count before this step, as
    optax's ``scale_by_schedule`` does. Adam's ``mu_dtype`` and SGD's
    ``accumulator_dtype`` store that slot in bfloat16, as optax does: the
    update runs in float32 and the slot is rounded when it is stored."""

    def __init__(self, params, rule: str, learning_rate, **hyper):
        if rule not in _RULES:
            raise ValueError(f"unknown optax rule: {rule}")
        super().__init__(params, dict(rule=rule, learning_rate=learning_rate, **hyper))

    def _init_state(self, group, p):
        state = {"count": 0}
        typed_slot, dtype_key = _SLOT_DTYPES.get(group["rule"], (None, None))
        for slot, init in _RULES[group["rule"]][1].items():
            value = group[init] if isinstance(init, str) else init
            dtype = group.get(dtype_key) if slot == typed_slot else None
            state[slot] = torch.full_like(
                p, value, dtype=dtype, memory_format=torch.preserve_format
            )
        return state

    def load_state_dict(self, state_dict):
        """As ``torch.optim.Optimizer``'s, which casts every slot to its
        parameter's dtype; a bfloat16 slot is cast back."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            slot, dtype_key = _SLOT_DTYPES.get(group["rule"], (None, None))
            if group.get(dtype_key) is None:
                continue
            for p in group["params"]:
                if slot in self.state.get(p, {}):
                    self.state[p][slot] = self.state[p][slot].to(group[dtype_key])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p] = self._init_state(group, p)
            states = [self.state[p] for p in params]
            count = states[0]["count"]
            slots = {
                slot: [s[slot] for s in states] for slot in _RULES[group["rule"]][1]
            }
            grads = [p.grad for p in params]
            update_fn = _RULES[group["rule"]][0]
            updates = update_fn(group, params, grads, slots, count)
            lr = group["learning_rate"]
            lr = lr(count) if callable(lr) else lr
            updates = torch._foreach_mul(updates, -lr)
            if group["rule"] == "rmsprop" and group["momentum"] is not None:
                updates, slots["trace"] = _trace(
                    updates, slots["trace"], group["momentum"], group["nesterov"]
                )
            torch._foreach_add_(params, updates)
            for i, s in enumerate(states):
                s["count"] = count + 1
                for slot, values in slots.items():
                    s[slot] = values[i].to(s[slot].dtype)
        return loss


def _reject(**unsupported) -> None:
    for name, value in unsupported.items():
        if value is not None:
            raise NotImplementedError(f"{name}={value!r} is not supported by the port")


def _slot_dtype(dtype):
    """A slot dtype as optax takes it ("bfloat16", a torch dtype, ...);
    None keeps the parameter's float32."""
    return None if dtype is None else compute_dtype(dtype)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
         *, nesterov=False):
    """optax.adam; returns ``params -> Optimizer``."""
    return functools.partial(
        OptaxRule, rule="adam", learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
        eps_root=eps_root, nesterov=nesterov, weight_decay=None,
        mu_dtype=_slot_dtype(mu_dtype),
    )


nadam = functools.partial(adam, nesterov=True)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
          weight_decay=1e-4, mask=None, *, nesterov=False):
    """optax.adamw (decay added to the Adam update before the learning
    rate); returns ``params -> Optimizer``."""
    _reject(mask=mask)
    return functools.partial(
        OptaxRule, rule="adam", learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
        eps_root=eps_root, nesterov=nesterov, weight_decay=weight_decay,
        mu_dtype=_slot_dtype(mu_dtype),
    )


def sgd(learning_rate, momentum=None, nesterov=False, accumulator_dtype=None):
    """optax.sgd; returns ``params -> Optimizer``."""
    return functools.partial(
        OptaxRule, rule="sgd", learning_rate=learning_rate, momentum=momentum,
        nesterov=nesterov, accumulator_dtype=_slot_dtype(accumulator_dtype),
    )


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
            centered=False, momentum=None, nesterov=False, bias_correction=False):
    """optax.rmsprop (momentum traced after the learning rate); returns
    ``params -> Optimizer``."""
    return functools.partial(
        OptaxRule, rule="rmsprop", learning_rate=learning_rate, decay=decay, eps=eps,
        initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt, centered=centered,
        momentum=momentum, nesterov=nesterov, bias_correction=bias_correction,
    )


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """optax.adagrad; returns ``params -> Optimizer``."""
    return functools.partial(
        OptaxRule, rule="adagrad", learning_rate=learning_rate,
        initial_accumulator_value=initial_accumulator_value, eps=eps,
    )


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adamax (eps added to |g| inside the max); returns ``params ->
    Optimizer``."""
    return functools.partial(
        OptaxRule, rule="adamax", learning_rate=learning_rate, b1=b1, b2=b2, eps=eps
    )


# --- name-based optimizer surface (one table for the constructed optimizer
# --- and the artifact snapshot), as in the JAX package ---------------------

_OPTIMIZER_FACTORIES = {
    "adam": adam,
    "adamw": adamw,
    "sgd": sgd,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "nadam": nadam,
    "adamax": adamax,
}
# The Keras class __name__ of each: the reference's ``optimizer`` artifact
# attr and ``optimizer.get_config()["name"]``.
KERAS_OPTIMIZER_NAMES = {
    "adam": "Adam",
    "adamw": "AdamW",
    "sgd": "SGD",
    "rmsprop": "RMSprop",
    "adagrad": "Adagrad",
    "nadam": "Nadam",
    "adamax": "Adamax",
}
_KERAS_TO_OPTAX = {"beta_1": "b1", "beta_2": "b2", "epsilon": "eps"}
_OPTAX_TO_KERAS = {v: k for k, v in _KERAS_TO_OPTAX.items()}
_KERAS_EPSILON_DEFAULT = 1e-7


def _keras_default_learning_rate(name: str) -> float:
    # every Keras optimizer here defaults to 1e-3 except SGD's 0.01
    return 0.01 if name == "sgd" else 1e-3


def _resolve_named_params(name: str, opt_params: dict) -> dict:
    """User params (Keras or optax names) over the Keras defaults, in optax
    names: what the factory is called with."""
    params = {_KERAS_TO_OPTAX.get(k, k): v for k, v in dict(opt_params).items()}
    params.setdefault("learning_rate", _keras_default_learning_rate(name))
    if "eps" in inspect.signature(_OPTIMIZER_FACTORIES[name]).parameters:
        params.setdefault("eps", _KERAS_EPSILON_DEFAULT)
    if name == "rmsprop" and "rho" in params:
        params["decay"] = params.pop("rho")
    return params


def resolved_optimizer_config(opt_con, opt_params: dict) -> dict:
    """The optimizer's whole config in Keras key names (the reference's
    ``optimizer.get_config()`` snapshot), from the same resolution
    :func:`build_optimizer` constructs with, then the factory's other
    scalar defaults. A callable ``opt_con`` records the user's params."""
    if callable(opt_con):
        return dict(opt_params)
    name = str(opt_con).lower()
    factory = _OPTIMIZER_FACTORIES.get(name)
    if factory is None:
        return dict(opt_params)

    def keras_key(optax_key):
        if name == "rmsprop" and optax_key == "decay":
            return "rho"
        return _OPTAX_TO_KERAS.get(optax_key, optax_key)

    cfg = {"name": KERAS_OPTIMIZER_NAMES.get(name, name)}
    for pname, p in inspect.signature(factory).parameters.items():
        if p.default is not inspect.Parameter.empty and isinstance(
            p.default, (bool, int, float, str)
        ):
            cfg[keras_key(pname)] = p.default
    cfg.update(
        (keras_key(k), v) for k, v in _resolve_named_params(name, opt_params).items()
    )
    return cfg


def build_optimizer(opt_con, opt_params: dict) -> Callable:
    """An optimizer factory ``params -> torch.optim.Optimizer``.

    ``opt_con`` is a name ('Adam', 'sgd', ...) with Keras-style kwargs,
    built with the Keras defaults over optax's rules, or a callable: it is
    called with ``opt_params`` (Keras names mapped to optax's) and must
    return such a factory, e.g. ``lambda learning_rate:
    functools.partial(torch.optim.SGD, lr=learning_rate)``."""
    if callable(opt_con):
        params = {_KERAS_TO_OPTAX.get(k, k): v for k, v in dict(opt_params).items()}
        return opt_con(**params)
    name = str(opt_con).lower()
    if name not in _OPTIMIZER_FACTORIES:
        raise ValueError(f"Unknown optimizer: {opt_con}")
    return _OPTIMIZER_FACTORIES[name](**_resolve_named_params(name, opt_params))
