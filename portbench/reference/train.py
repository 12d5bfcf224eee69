"""Plain training step: the device augmentation, the forward in train mode,
focal + Dice loss, the gradient and optax's Adam, in plain ``torch``.

The random draws follow the training cell's stream, from a
``torch.Generator`` seeded as the benchmark seeds the program's: per step,
first ``randn`` of the images' shape for every noise augmentation in the
traffic's list order, then ``rand`` of the bottleneck's NCHW shape for the
dropout keep-mask (kept where the draw is below 0.5). Each sample takes the
augmentation its ``choice`` names (-1: none): a flip along the named axis,
images and labels together, or ``clip(x + mean + sqrt(var) * z, 0, 1)``.
"""

from __future__ import annotations

import math

import torch

from . import precision

EPS_KERAS = 1e-7


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def focal_dice_loss(labels, probs, num_classes: int, gamma: float = 2.0, weight: float = 0.5,
                    smooth: float = 1e-5):
    """``weight * mean(focal) + (1 - weight) * macro Dice loss``; ``labels``
    ``(B, H, W)`` integers, ``probs`` ``(B, H, W, C)``."""
    onehot = (labels.long()[..., None] == torch.arange(num_classes, device=labels.device)).float()
    p = _clip(probs, EPS_KERAS, 1.0)
    p_y = _clip((p * onehot).sum(-1), EPS_KERAS, 1.0)
    focal = (-((1.0 - p_y) ** gamma) * torch.log(p_y)).mean()
    inter = (onehot * probs).sum(dim=(1, 2))
    denom = onehot.sum(dim=(1, 2)) + probs.sum(dim=(1, 2))
    dice = 1.0 - ((2.0 * inter + smooth) / (denom + smooth)).mean()
    return weight * focal + (1.0 - weight) * dice


def augment(generator, images, labels, choices, augment_list):
    """``images`` ``(B, H, W, 1)`` float in [0, 1], ``labels`` ``(B, H, W,
    1)``, ``choices`` ``(B,)`` -> augmented images and labels."""
    out_i, out_l = images, labels
    for k, (kind, *args) in enumerate(augment_list):
        if kind == "flip":
            axis = {"up-down": 1, "left-right": 2}[args[0]]
            bi, bl = images.flip(axis), labels.flip(axis)
        elif kind == "gaussian":
            mean, var = args
            z = torch.randn(images.shape, generator=generator, device=images.device, dtype=images.dtype)
            bi, bl = torch.clamp(images + (mean + math.sqrt(var) * z), 0.0, 1.0), labels
        else:
            raise ValueError(f"unknown augmentation {kind!r}")
        sel = (choices == k).reshape(-1, 1, 1, 1)
        out_i = torch.where(sel, bi, out_i)
        out_l = torch.where(sel, bl, out_l)
    return out_i, out_l


class Adam:
    """optax.adam with the Keras defaults the configuration names."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu, self.nu, self.count = {}, {}, 0

    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        with torch.no_grad():
            for name, g in grads.items():
                mu = self.mu.get(name, torch.zeros_like(g))
                nu = self.nu.get(name, torch.zeros_like(g))
                self.mu[name] = (1.0 - self.b1) * g + self.b1 * mu
                self.nu[name] = (1.0 - self.b2) * g * g + self.b2 * nu
                update = (self.mu[name] / c1) / (torch.sqrt(self.nu[name] / c2) + self.eps)
                params[name] -= self.lr * update


def train_steps(model, params: dict, batches, cfg: dict, traffic: dict, generator, precise=True):
    """Replay ``len(batches)`` steps from ``params`` (trainable leaves are
    updated in place); ``batches`` are ``(images, labels, choices)`` device
    tensors. Returns ``(losses, first_grads)``: each step's loss and the
    first step's gradient per leaf, as plain floats and tensors."""
    from . import unet

    trainable = [n for n, _s, kind in model.param_spec(cfg) if kind in ("conv_w", "conv_b", "bn_w", "bn_b")]
    opt = Adam(traffic["learning_rate"])
    losses, first = [], None
    for images, labels, choices in batches:
        images, labels = augment(generator, images, labels, choices, traffic["augment"])
        x = images * 255.0 / 255.0
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        keep = torch.rand(unet.bottleneck_shape(cfg, b, h, w), generator=generator,
                          device=x.device, dtype=torch.float32) < 0.5
        leaves = {n: params[n].detach().requires_grad_() for n in trainable}
        full = {**params, **leaves}
        with precision(precise):
            probs = torch.softmax(model.logits(full, x, cfg, train=True, keep=keep), dim=1).permute(0, 2, 3, 1)
            loss = focal_dice_loss(labels[..., 0], probs, cfg["num_classes"])
            grads = dict(zip(trainable, torch.autograd.grad(loss, [leaves[n] for n in trainable])))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first
