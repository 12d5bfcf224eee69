"""Precise BatchNorm statistics ("precise BN"), counterpart of the JAX
package's ``ops/bn_refresh.py``.

The running statistics that training leaves behind are a momentum-0.99
average over the whole trajectory; this recomputes every BatchNorm's
statistics as exact population statistics of the training data under
given weights, in one pass. Each batch's raw statistics are recovered from
the momentum update anchored at zero (``new_ra = (1 - m) * s_b``, so
``s_b = new_ra / (1 - m)``), then aggregated over equal-size batches by
the law of total variance (``mean = E_b[mean_b]``, ``var = E_b[var_b +
mean_b^2] - mean^2``, clamped at 0).

The training driver uses it to finalise saved checkpoints
(``bn_precise_stats``) and for the statistics behind each epoch's
validation metrics (``bn_precise_val``). In a run of several ranks
(``cross_process=True``) the per-batch accumulators and their count are
summed over the world before the average, so every rank gets the
statistics of every rank's batches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import module_dtype, precision
from ..models.unet import BN_MOMENTUM
from ..parallel.mesh import sum_over_world


def _stat_buffers(module: torch.nn.Module) -> dict:
    return {
        name: buf
        for name, buf in module.named_buffers()
        if name.endswith(("running_mean", "running_var"))
    }


class BNRefresher:
    """Reusable precise-BN statistics computer for one module.

    Args:
      module: the training module (a ``UNetModule``); its weights and
        statistics are left as they were after every call.
      momentum: the module's BatchNorm momentum (the recovery's input).
      deterministic: collect under a dropout-off forward with BatchNorm in
        batch-statistics mode (``stats_mode=True``). The default (False)
        collects under the dropout-active training forward, the
        distribution the rolling statistics and Keras's ``fit`` see.
    """

    def __init__(self, module, momentum: float = BN_MOMENTUM, deterministic: bool = False):
        self.deterministic = bool(deterministic)
        self._module = module
        self._momentum = momentum

    def _raw_batch_stats(self, x, generator) -> dict:
        buffers = _stat_buffers(self._module)
        with torch.no_grad():
            # Anchored at zero: the batch-statistics forward normalises with
            # the batch's own statistics, so the anchor does not change it.
            for buf in buffers.values():
                buf.zero_()
            if self.deterministic:
                self._module.eval()
                self._module(x, stats_mode=True)
            else:
                self._module.train()
                self._module(x, generator=generator)
            return {
                name: buf.to(torch.float32) / (1.0 - self._momentum)
                for name, buf in buffers.items()
            }

    def __call__(self, params, batches, generator=None, cross_process: bool = False) -> dict:
        """Exact population statistics of ``batches`` under ``params``.

        Args:
          params: a ``state_dict`` of the module to take the weights from
            (its statistics are ignored), or None for the module's own.
          batches: iterable of equal-size preprocessed input batches on
            the module's device.
          generator: the dropout generator (ignored when deterministic); a
            generator seeded with 0 when None.
          cross_process: sum the accumulators and their count over every
            rank of the initialised process group (an all-reduce on the
            device, equal to JAX's gather-then-sum). Every rank must call
            with the same number of batches of one size; unequal counts
            raise on every rank.

        Returns ``{buffer name: tensor}`` for every ``running_mean`` and
        ``running_var``, as ``parallel.train_step.batch_stats`` gives
        them, float32 also for a bfloat16 module. The forwards run under
        the module's precision context (``_device.precision``).
        Raises ValueError on an empty ``batches``."""
        if cross_process and not dist.is_initialized():
            raise ValueError("cross_process=True needs an initialised process group")
        module = self._module
        device = next(module.parameters()).device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        saved = {k: v.detach().clone() for k, v in module.state_dict().items()}
        was_training = module.training
        try:
            if params is not None:
                module.load_state_dict(params)
            total, count = None, 0
            with precision(module_dtype(module)):
                for x in batches:
                    s = self._raw_batch_stats(x, generator)
                    term = {}
                    for name, value in s.items():
                        if name.endswith("running_var"):
                            mean = s[name[: -len("running_var")] + "running_mean"]
                            value = value + mean**2
                        term[name] = value
                    total = term if total is None else {k: total[k] + term[k] for k in total}
                    count += 1
        finally:
            module.load_state_dict(saved)
            module.train(was_training)
        if cross_process:
            total, count = _sum_over_world(total, count, device)
        if total is None:
            raise ValueError("BNRefresher needs >= 1 batch")
        avg = {k: v / count for k, v in total.items()}
        out = {}
        for name, value in avg.items():
            if name.endswith("running_var"):
                mean = avg[name[: -len("running_var")] + "running_mean"]
                value = torch.maximum(value - mean**2, torch.zeros((), device=value.device))
            out[name] = value
        return out


def _sum_over_world(total, count: int, device) -> tuple:
    """``(total, count)`` summed over every rank. The counts are compared
    first, on every rank, so that unequal counts (an empty rank included)
    raise everywhere instead of leaving a rank in the sum."""
    counts = torch.tensor([count, -count], dtype=torch.int64, device=device)
    dist.all_reduce(counts, op=dist.ReduceOp.MAX)
    most, fewest = int(counts[0]), -int(counts[1])
    if most != fewest:
        raise ValueError(
            f"cross-process BN refresh: ranks hold {fewest} to {most} batches; "
            "every rank must pass the same number"
        )
    if total is None:
        return None, 0
    names = list(total)
    summed = sum_over_world([total[k] for k in names])
    return dict(zip(names, summed)), count * dist.get_world_size()


def compute_precise_batch_stats(
    module,
    params,
    batches,
    generator=None,
    momentum: float = BN_MOMENTUM,
    deterministic: bool = False,
    cross_process: bool = False,
) -> dict:
    """One-shot wrapper over :class:`BNRefresher`."""
    refresher = BNRefresher(module, momentum=momentum, deterministic=deterministic)
    return refresher(params, batches, generator=generator, cross_process=cross_process)
