"""The port's losses and metrics against the JAX package's, on the same
seeded inputs: values, and gradients with respect to ``y_pred``
(``jax.grad`` against autograd).

The predictions include saturated softmax pixels (p exactly 1.0 and 0.0)
and values exactly at the clip bounds 1e-7 and 1 - 1e-7, where
``jnp.clip`` passes half the gradient and ``torch.clamp`` all of it.

Tolerances: loss and metric values rel 1e-5 (float32 sums in another
order); gradients per tensor max|d| <= 1e-4 * max|g| + 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.ops import losses as jl
from oct_image_segmentation_models_tpu.ops import metrics as jm
from oct_image_segmentation_models_torch.common import custom_losses, custom_metrics
from oct_image_segmentation_models_torch.ops import losses as tl
from oct_image_segmentation_models_torch.ops import metrics as tm

B, H, W, C = 2, 12, 16, 4
RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, size=(B, H, W, C)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    p = p.astype(np.float32)
    labels = rng.integers(0, C, size=(B, H, W, 1)).astype(np.int32)
    # Saturated softmax: exact one-hot pixels, half of them on the label.
    p[0, :3, :4] = np.eye(C, dtype=np.float32)[labels[0, :3, :4, 0]]
    p[1, :2, :3] = np.eye(C, dtype=np.float32)[(labels[1, :2, :3, 0] + 1) % C]
    # Values exactly at the clip bounds.
    p[0, 5, :, 0] = np.float32(1e-7)
    p[1, 6, :, 1] = np.float32(1.0 - 1e-7)
    onehot = np.eye(C, dtype=np.float32)[labels[..., 0]]
    return p, labels, onehot


def _check_value(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= RTOL * max(abs(want), 1e-6), (got, want)


def _check_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * float(np.abs(want).max()) + GRAD_ABS, err


def _both(jax_fn, torch_fn, y_true_np, p_np):
    """(value, grad) of ``fn(y_true, y_pred)`` w.r.t. y_pred, in JAX and in
    the port."""
    jv, jg = jax.value_and_grad(lambda p: jax_fn(jnp.asarray(y_true_np), p))(
        jnp.asarray(p_np)
    )
    p = torch.tensor(p_np, requires_grad=True)
    tv = torch_fn(torch.from_numpy(y_true_np), p)
    tv.backward()
    return (np.asarray(jv), np.asarray(jg)), (tv.detach().numpy(), p.grad.numpy())


REGISTRY_CASES = [
    ("bce_dice_loss", {}),
    ("dice_loss_micro", {}),
    ("dice_loss_macro", {}),
    ("focal_loss", {}),
    ("focal_loss", {"class_weight": [0.5, 1.0, 2.0, 1.5], "gamma": 3}),
    ("bce_focal_loss", {}),
    ("focal_dice_loss", {}),
    ("focal_dice_loss", {"dice_macro": False, "focal_loss_weight": 0.3}),
    ("focal_dice_loss", {"class_weight": np.array([1.0, 2.0, 0.5, 4.0, 9.0])}),
]


@pytest.mark.parametrize("name,kwargs", REGISTRY_CASES)
def test_registry_loss_value_and_grad(name, kwargs):
    p, labels, onehot = _inputs()
    entry_j = jl.custom_loss_objects[name]
    entry_t = custom_losses.custom_loss_objects[name]
    assert entry_t["takes_sparse"] == entry_j["takes_sparse"]
    sparse = entry_j["takes_sparse"]
    make = dict(num_classes=C, is_y_true_sparse=sparse, **kwargs)
    y_true = labels if sparse else onehot
    (jv, jg), (tv, tg) = _both(
        entry_j["function"](**make), entry_t["function"](**make), y_true, p
    )
    _check_value(tv, jv)
    _check_grad(tg, jg)


def test_sparse_losses_take_labels_without_channel_axis():
    p, labels, _ = _inputs(1)
    for name in ("focal_loss", "focal_dice_loss"):
        make = dict(num_classes=C, is_y_true_sparse=True)
        (jv, jg), (tv, tg) = _both(
            jl.custom_loss_objects[name]["function"](**make),
            tl.custom_loss_objects[name]["function"](**make),
            labels[..., 0],
            p,
        )
        _check_value(tv, jv)
        _check_grad(tg, jg)


def test_focal_out_of_range_labels_match_jax():
    """A label at or above the channel count: the pixel sits at the clip
    floor without class weights and drops out with them, as in JAX."""
    p, labels, _ = _inputs(2)
    labels = labels.copy()
    labels[0, 0, :5, 0] = C + 1
    for kwargs in ({}, {"class_weight": [1.0, 2.0, 3.0, 4.0]}):
        (jv, jg), (tv, tg) = _both(
            jl.focal_loss(**kwargs), tl.focal_loss(**kwargs), labels, p
        )
        _check_value(tv, jv)
        _check_grad(tg, jg)
    with pytest.raises(ValueError, match="one weight per class"):
        tl.focal_loss(class_weight=[1.0, 2.0])(torch.from_numpy(labels), torch.from_numpy(p))


def test_off_registry_losses_value_and_grad():
    p, labels, onehot = _inputs(3)
    weights = [0.25, 1.0, 2.0, 0.75]
    cases = [
        (jl.weighted_categorical_crossentropy(weights), tl.weighted_categorical_crossentropy(weights)),
        (jl.bce_logdice_loss, tl.bce_logdice_loss),
        (jl.weighted_bce_dice_loss, tl.weighted_bce_dice_loss),
    ]
    for jax_fn, torch_fn in cases:
        (jv, jg), (tv, tg) = _both(jax_fn, torch_fn, onehot, p)
        _check_value(tv, jv)
        _check_grad(tg, jg)
    weight = np.random.default_rng(4).uniform(0.1, 3.0, size=p.shape).astype(np.float32)
    for jax_fn, torch_fn in (
        (jl.weighted_bce_loss, tl.weighted_bce_loss),
        (jl.weighted_dice_loss, tl.weighted_dice_loss),
    ):
        (jv, jg), (tv, tg) = _both(
            lambda t, q, f=jax_fn: f(t, q, jnp.asarray(weight)),
            lambda t, q, f=torch_fn: f(t, q, torch.from_numpy(weight)),
            onehot,
            p,
        )
        _check_value(tv, jv)
        _check_grad(tg, jg)


def test_same_avg_pool_matches_tf_semantics():
    """The 50x50 "SAME" average pool behind weighted_bce_dice_loss, on an
    image smaller and larger than the window: valid elements only."""
    rng = np.random.default_rng(5)
    for shape in ((1, 12, 16, 2), (1, 60, 70, 1)):
        x = rng.random(shape).astype(np.float32)
        want = np.asarray(jl._same_avg_pool_hw(jnp.asarray(x), 50))
        got = tl._same_avg_pool_hw(torch.from_numpy(x), 50).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_clip_gradient_at_the_bounds_is_jnp_clip():
    """The clip trap: jnp.clip passes half the gradient at a bound."""
    x_np = np.array([1.0, 0.5, 1e-7], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 1e-7, 1.0).sum())(jnp.asarray(x_np)))
    np.testing.assert_array_equal(want, [0.5, 1.0, 0.5])
    x = torch.tensor(x_np, requires_grad=True)
    tl._clip(x, 1e-7, 1.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)


def test_balanced_class_weight_equal():
    labels = np.random.default_rng(6).integers(0, 5, size=(3, 20, 7, 1))
    labels[labels == 3] = 4  # a class absent in the middle
    np.testing.assert_array_equal(
        tl.compute_balanced_class_weight(labels), jl.compute_balanced_class_weight(labels)
    )


@pytest.mark.parametrize("name", ["dice_coef_micro", "dice_coef_macro"])
@pytest.mark.parametrize("sparse", [True, False])
def test_training_monitor_metrics(name, sparse):
    p, labels, onehot = _inputs(7)
    y_true = labels if sparse else onehot
    want = jm.training_monitor_metric_objects[name](sparse, C)(jnp.asarray(y_true), jnp.asarray(p))
    got = custom_metrics.training_monitor_metric_objects[name](sparse, C)(
        torch.from_numpy(y_true), torch.from_numpy(p)
    )
    assert got.ndim == 0 and got.dtype == torch.float32
    _check_value(got, want)
    assert tm.training_monitor_metric_objects[name] is custom_metrics.training_monitor_metric_objects[name]


def test_soft_dice_class():
    rng = np.random.default_rng(8)
    t = (rng.random((2, 3, 9, 11)) > 0.5).astype(np.float32)
    q = rng.random((2, 3, 9, 11)).astype(np.float32)
    want = np.asarray(jm.soft_dice_class(t, q))
    for args in ((t, q), (torch.from_numpy(t), torch.from_numpy(q))):
        got = custom_metrics.soft_dice_class(*args).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)
