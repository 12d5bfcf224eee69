"""The training loop ``train_model`` runs per step, on one device: the
forward ``resolve_train_forward`` picks under "auto", ``create_train_state``
with Adam, the registry's loss and metric, ``build_device_augmenter`` for
the traffic's augmentations, and ``make_train_step`` fed by
``prefetch_to_mesh`` from host batches of a seeded pool.

Traffic keys: ``pool``, ``batch_size``, ``learning_rate``, ``loss``,
``metric``, ``augment`` (``["flip", axis]`` or ``["gaussian", mean,
variance]``, in the order the step draws them), ``check_steps``. The host
batches are the pool in an order drawn from the seed, ``batch_size`` rows
each, cycled; every sample's augmentation is drawn from the seed. Set-up
runs the first ``check_steps`` steps through the same loop, feed and
state as the window; the reference replays them after the window. The
window closes at the ``synchronize`` after the first step enqueued after
``--seconds``.
"""

from __future__ import annotations

import importlib
import itertools
import time

import numpy as np
import torch

from portbench.harness import cell as cell_lib
from portbench.harness import data, flops, judge
from portbench.harness import trace as trace_lib

B1 = 0.9  # Adam's first-moment decay: the first gradient is mu / (1 - B1)


def host_batches(cell, images, labels):
    """``[(images f32 (B, H, W, 1) in [0, 1], labels u8, choices i32 (B,))]``
    covering the pool once."""
    t = cell.traffic
    b = t["batch_size"]
    perm = data.rng(cell.seed, data.ORDER).permutation(len(images))
    choices = data.rng(cell.seed, data.CHOICES).integers(0, len(t["augment"]), size=len(images))
    out = []
    for i in range(0, len(perm) - b + 1, b):
        rows = perm[i : i + b]
        out.append((images[rows].astype(np.float32) / 255.0, labels[rows].copy(),
                    choices[i : i + b].astype(np.int32)))
    return out


def aug_fn_args(augment: list) -> list:
    from oct_image_segmentation_models_torch.common.augmentation import add_noise_aug, flip_aug

    out = []
    for kind, *args in augment:
        if kind == "flip":
            out.append((flip_aug, {"flip_type": args[0]}))
        else:
            out.append((add_noise_aug, {"mode": kind, "mean": args[0], "variance": args[1]}))
    return out


def run(cell) -> cell_lib.Outcome:
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops import losses, metrics
    from oct_image_segmentation_models_torch.ops.augment import build_device_augmenter
    from oct_image_segmentation_models_torch.parallel.input_pipeline import prefetch_to_mesh
    from oct_image_segmentation_models_torch.parallel.mesh import Mesh
    from oct_image_segmentation_models_torch.parallel.train_step import (
        build_optimizer, create_train_state, make_train_step)
    from oct_image_segmentation_models_torch.training.training import resolve_train_forward

    dev, t, kw = cell.device, cell.traffic, cell.model
    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    images, labels = data.make_pool(cell.seed, cell.config, t)
    marks = {"pool": time.perf_counter()}
    weights = data.make_weights(ref.param_spec(kw), cell.seed, dev)
    name = cell.config["model"]["name"]
    container = get_model_class(name)(**kw)
    module = container.build_model(device=dev)
    module.load_state_dict(weights)
    forward, kind = resolve_train_forward(module, container.get_config(), kw["image_height"],
                                          kw["image_width"], "auto")
    state = create_train_state(module, build_optimizer("adam", {"learning_rate": t["learning_rate"]}))
    classes = kw["num_classes"]
    loss_fn = losses.custom_loss_objects[t["loss"]]["function"](num_classes=classes, is_y_true_sparse=True)
    metric_fn = metrics.training_monitor_metric_objects[t["metric"]](True, classes)
    augmenter = build_device_augmenter(aug_fn_args(t["augment"]))
    preprocess = container.get_preprocess_input_fn()

    def input_transform(gen, im, lb, ch):
        im, lb = augmenter(gen, im, lb, ch)
        return preprocess(im * 255.0), lb

    step = make_train_step(forward, loss_fn, metric_fn, None, impl="auto", input_transform=input_transform)
    generator = torch.Generator(device=dev).manual_seed(data.torch_seed(cell.seed, data.STEPS))
    batches = host_batches(cell, images, labels)
    if len(batches) < t["check_steps"]:
        raise ValueError("the pool must give every checked step rows of its own")
    feed = prefetch_to_mesh(itertools.cycle(batches), Mesh(1, 1, 0, dev))
    params = dict(module.named_parameters())

    marks["build"] = time.perf_counter()
    # Set-up: the first steps, through the window's own loop and feed.
    check_losses, first_mu = [], None
    for _ in range(t["check_steps"]):
        batch = next(feed)
        state, loss, _metric = step(state, batch[0], batch[1], generator, batch[2])
        check_losses.append(loss)
        if first_mu is None:
            # An optimizer that kept no moment got no gradient.
            first_mu = {n: state.optimizer.state[p].get("mu", torch.zeros_like(p)).clone()
                        for n, p in params.items()}
    after = {n: p.detach().clone() for n, p in params.items()}
    cell_lib.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    phases, traces, window_losses = [], [], []
    timed = cell.trace and dev.type == "cuda"

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    t_start = time.perf_counter()
    setup_s = t_start - cell.started
    deadline = t_start + cell.seconds
    steps = 0
    with trace_lib.capture(cell.trace, traces), torch.profiler.record_function("window"):
        while True:
            with torch.profiler.record_function("next_batch"):
                batch = next(feed)
            stamps = {}
            hook = (lambda phase, m=stamps: m.__setitem__(phase, event())) if timed else None
            with torch.profiler.record_function("step"):
                state, loss, _metric = step(state, batch[0], batch[1], generator, batch[2], on_phase=hook)
            window_losses.append(loss)
            if timed:
                phases.append(stamps)
            steps += 1
            if time.perf_counter() >= deadline:
                break
        cell_lib.sync(dev)
        window_s = time.perf_counter() - t_start
    feed.close()
    peak = cell_lib.memory_peak(dev)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    backward_ms = [m["forward"].elapsed_time(m["backward"]) for m in phases]
    program = {
        "losses": [float(x) for x in check_losses],
        "grads": {n: mu / (1.0 - B1) for n, mu in first_mu.items()},
        "changes": {n: after[n] - weights[n] for n in params},
    }
    del state, step, forward, module, feed, params, after, first_mu
    cell_lib.free(dev)

    readings = replay_readings(cell, ref, weights, batches[: t["check_steps"]], program)
    correct, checks = judge.checks(readings, cell.limits)
    e2e = {"train_bscans_per_s": steps * t["batch_size"] / window_s, "setup_s": setup_s}
    trace = traces[0] if traces else None
    context = {
        "steps": steps,
        "batch_size": t["batch_size"],
        "forward_flops": flops.forward_flops(cell.config),
        "peak_flops": flops.PEAK_FLOPS[cell.config["dtype"]],
        "backward_ms": backward_ms,
        "trace": trace,
    }
    marks["checked_steps"] = t_start
    notes = {"setup_marks": {k: v - cell.started for k, v in marks.items()}, "steps": steps, "window_s": window_s, "forward": kind,
             "leaves_left_out": readings["leaves_left_out"]}
    return cell_lib.Outcome(e2e, context, steps, failed, correct, checks, peak, trace, notes)


def reference_run(cell, ref, weights, batches, precise=True, rows=None) -> dict:
    """The reference's steps from ``weights`` on the same batches and
    draws: ``{"losses", "grads", "changes"}`` as the program's are kept.
    ``rows`` keeps only those rows of each batch (a planted fault);
    ``precise=False`` runs in TF32 (the control)."""
    from portbench.reference import train as train_ref

    dev = cell.device
    gen = torch.Generator(device=dev).manual_seed(data.torch_seed(cell.seed, data.STEPS))
    params = {n: w.clone() for n, w in weights.items()}
    sel = slice(None) if rows is None else rows
    dev_batches = [tuple(torch.from_numpy(a[sel]).to(dev) for a in batch) for batch in batches]
    losses, grads = train_ref.train_steps(ref, params, dev_batches, cell.model, cell.traffic, gen, precise)
    return {"losses": losses, "grads": grads, "changes": {n: params[n] - weights[n] for n in grads}}


def replay_readings(cell, ref, weights, batches, program) -> dict:
    """The numbers of ``program``'s first steps against the reference's."""
    want = reference_run(cell, ref, weights, batches)
    return judge.train_readings(program["losses"], program["grads"], program["changes"],
                                want["losses"], want["grads"], want["changes"])
