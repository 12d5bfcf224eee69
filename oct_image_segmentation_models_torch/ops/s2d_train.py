"""Space-to-depth U-Net forward for training, counterpart of the JAX
package's ``ops/s2d_train.py``.

:mod:`.s2d_unet` transforms the conv stack for inference (BatchNorm
folded, weights baked into buffers). This module applies the same layout
transform inside the train step, differentiably:

- the block kernels are built from the parity kernels in every forward
  (:func:`.s2d_unet.transform_kernel_torch`, one gather, linear in the
  weights), so autograd returns the conv gradients to the parity kernels
  exactly;
- BatchNorm runs unfolded, with batch statistics over real pixels only:
  at a shifted block alignment the ghost rows and columns (original rows
  -1 and H, the SAME padding) are zeroed before the sums and left out of
  the divisor, then zeroed again after the ReLU, so that the next conv
  still reads padding zeros;
- the bottleneck's dropout mask is the parity module's
  (:func:`..models.unet.dropout_mask` on the bottleneck's NCHW shape),
  so that the same generator gives the same mask.

:class:`S2DTrainForward` holds the parity module's own ``blocks`` and
``head``: its parameters and BatchNorm buffers are the parity module's
tensors under the parity module's ``state_dict`` keys, so the optimizer,
checkpoints, ``batch_stats``/``load_batch_stats`` and
:class:`.bn_refresh.BNRefresher` take either module. Its ``forward`` has
``UNetModule.forward``'s contract.

BatchNorm is JAX's ``_batchnorm`` here, not :class:`..models.unet.
BatchNorm`: ``scale = gamma * rsqrt(var + eps)`` and ``offset = beta -
mean * scale``, both in float32 (float64 for a float64 module) and cast to
the stack's dtype, then ``y = t * scale + offset``; the variance is not
clamped at 0; statistics are per original channel over the 4 phases.

``dtype="bfloat16"`` (the parity module's ``compute_dtype``) runs the conv
stack in bfloat16 and the statistics in float32, as JAX's
``S2DTrainForward(dtype=)`` does. XLA on the CPU keeps every bfloat16
rounding of this forward (unlike the parity module's, where it drops the
rounding of conv + bias before BatchNorm): the conv's output, the sum
with the bias, ``scale`` and ``offset``, then the product and the sum of
``t * scale + offset``; the statistics read the rounded sum promoted to
float32. The port rounds at the same places, and its bfloat16 forward is
bit-equal to JAX's in eval mode (``tests/test_torch_s2d_train.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models import unet as unet_lib
from ..models.unet import DROPOUT_RATE, UNetModule, _same_pads, stack_dtype
from ..parallel import mesh as mesh_lib
from .s2d_unet import (
    _conv_nchw,
    _conv_pads,
    _d2s_nchw,
    _mask_shifted_nchw,
    _phase_max_pool_nchw,
    _s2d_nchw,
    _split_concat_perm,
    _transform_maps,
    s2d_eligible_levels,
    transform_kernel_torch,
)

__all__ = ["S2DTrainForward", "maybe_build_s2d_train"]

# Block alignments (a_in, a_out) of each transformed conv kind.
_ALIGN = {"A": (0, 1), "B": (1, 0), "C": (0, 0)}


def maybe_build_s2d_train(module, model_config: dict, image_height: int, image_width: int):
    """:class:`S2DTrainForward` over ``module`` when the model and the
    geometry qualify, else None (train the parity module), as JAX decides:
    ``module`` must be a :class:`UNetModule` whose config has s2d-eligible
    levels, and both image dims must stay even through every transformed
    level (divisible by ``2**levels``)."""
    if model_config is None or not isinstance(module, UNetModule):
        return None
    levels = s2d_eligible_levels(
        model_config.get("start_neurons", 8),
        model_config.get("pool_layers", 4),
        model_config.get("conv_layers", 2),
        tuple(model_config.get("enc_kernel", (3, 3))),
        tuple(model_config.get("dec_kernel", (2, 2))),
    )
    if levels == 0:
        return None
    div = 2**levels
    if image_height % div or image_width % div:
        return None
    return S2DTrainForward(module, s2d_levels=levels)


class S2DTrainForward(nn.Module):
    """The s2d training forward over a parity :class:`UNetModule` (with
    BatchNorm), counterpart of JAX's ``S2DTrainForward``. Built by
    :func:`maybe_build_s2d_train`, or directly with ``s2d_levels`` (None:
    :func:`.s2d_unet.s2d_eligible_levels` of the module's config)."""

    def __init__(self, module: UNetModule, s2d_levels: Optional[int] = None):
        super().__init__()
        if not isinstance(module, UNetModule) or not module.use_bn:
            raise ValueError("S2DTrainForward needs a UNetModule with BatchNorm")
        hp = module.hparams
        if s2d_levels is None:
            s2d_levels = s2d_eligible_levels(
                hp["start_neurons"], hp["pool_layers"], hp["conv_layers"],
                hp["enc_kernel"], hp["dec_kernel"],
            )
        if s2d_levels == 0:
            raise ValueError("the module's config has no s2d-eligible level")
        # The parity module's own submodules: the same parameters and
        # buffers under the same state_dict keys.
        self.blocks = module.blocks
        self.head = module.head
        self.compute_dtype = module.compute_dtype
        self.pool_layers = hp["pool_layers"]
        self.conv_layers = hp["conv_layers"]
        self.start_neurons = hp["start_neurons"]
        self.s2d_levels = s2d_levels
        ek, dk = hp["enc_kernel"], hp["dec_kernel"]
        self._maps = {
            kind: _transform_maps(*(dk if kind == "C" else ek), *_ALIGN[kind])
            for kind in _ALIGN
        }
        self._tensors = {}  # (key, device) -> index tensors, see _on
        self.train(module.training)

    def _on(self, device, key, arrays) -> tuple:
        """``arrays`` (numpy) as tensors on ``device``, copied once."""
        if (key, device) not in self._tensors:
            self._tensors[key, device] = tuple(torch.from_numpy(a).to(device) for a in arrays)
        return self._tensors[key, device]

    def _batchnorm(self, t, bn, batch_stats: bool, phases: int, real_count: int = None):
        """JAX's ``_batchnorm`` on an NCHW ``t`` whose channels are
        ``phases`` phase groups of the original channels."""
        B, CP, h, w = t.shape
        tr = t.reshape(B, phases, CP // phases, h, w)
        dims = (0, 1, 3, 4)
        stat_dtype = torch.promote_types(t.dtype, torch.float32)
        if batch_stats:
            n = B * phases * h * w if real_count is None else real_count
            t32 = tr.to(stat_dtype)
            sums = mesh_lib.sum_over_global_batch(
                torch.stack([t32.sum(dim=dims), (t32 * t32).sum(dim=dims)])
            )
            n = mesh_lib.global_batch_size(n)
            mean, mean2 = sums[0] / n, sums[1] / n
            var = mean2 - mean * mean
            with torch.no_grad():
                m = unet_lib.BN_MOMENTUM
                bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
                bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        scale = (
            bn.weight.to(stat_dtype) * torch.rsqrt(var.to(stat_dtype) + bn.eps)
        ).to(t.dtype)
        offset = (bn.bias.to(stat_dtype) - mean.to(stat_dtype) * scale.to(stat_dtype)).to(
            t.dtype
        )
        y = tr * scale[:, None, None] + offset[:, None, None]
        return y.reshape(B, CP, h, w)

    def _block(self, x, block, batch_stats, kind=None, in_perm=None, presum=False):
        """One conv + BatchNorm + ReLU block: a plain SAME conv (``kind``
        None) or a block-space conv of kind "A" (U -> S), "B" (S -> U) or
        "C" (U -> U)."""
        dtype = x.dtype
        w, b = block.conv.weight.to(dtype), block.conv.bias.to(dtype)
        if kind is None:
            y = _conv_nchw(x, w, b, _same_pads(w.shape[2:]))
            return F.relu(self._batchnorm(y, block.bn, batch_stats, phases=1))
        KI, KJ, mask, e_h, e_w = self._maps[kind]
        W2 = transform_kernel_torch(w, self._on(w.device, kind, (KI, KJ, mask)))
        if in_perm is not None:
            W2 = W2[:, self._on(w.device, ("perm", len(in_perm)), (in_perm,))[0]]
        if presum:
            # The upsample's 4 phases are equal: sum the kernel over the
            # input phase axis and read the scalar-form x directly.
            W2 = W2.reshape(W2.shape[0], 4, -1, *W2.shape[2:]).sum(dim=1)
        a_in, a_out = _ALIGN[kind]
        nh, nw = x.shape[2:]
        n_out_h, n_out_w = nh + (a_out - a_in), nw + (a_out - a_in)
        pads = _conv_pads(nh, nw, e_h, e_w, n_out_h, n_out_w)
        y = _conv_nchw(x, W2, b.repeat(4), pads)
        if a_out == 1:
            # Zero the ghost rows and columns before the sums and keep them
            # out of the divisor.
            y = _mask_shifted_nchw(y)
            real = y.shape[0] * 2 * (n_out_h - 1) * 2 * (n_out_w - 1)
            y = self._batchnorm(y, block.bn, batch_stats, phases=4, real_count=real)
            return _mask_shifted_nchw(F.relu(y))
        return F.relu(self._batchnorm(y, block.bn, batch_stats, phases=4))

    def forward(
        self,
        x: torch.Tensor,
        stats_mode: bool = False,
        generator: torch.Generator = None,
    ) -> torch.Tensor:
        """``UNetModule.forward``'s contract: ``(B, H, W, C)`` float input
        -> ``(B, H, W, classes)`` softmax probabilities; batch statistics
        in train mode or with ``stats_mode``, the dropout mask from
        ``generator`` in train mode."""
        batch_stats = self.training or stats_mode
        lv = self.s2d_levels
        x = x.to(stack_dtype(self)).permute(0, 3, 1, 2)
        blocks = iter(self.blocks)

        def run(x, kind=None, **kw):
            return self._block(x, next(blocks), batch_stats, kind, **kw)

        def pair_kind(j):
            return "A" if j % 2 == 0 else "B"

        skips = []
        for L in range(self.pool_layers):
            if L < lv:
                if x.shape[2] % 2 or x.shape[3] % 2:
                    raise ValueError("the s2d training forward needs even spatial dims")
                x = _s2d_nchw(x)
                for j in range(self.conv_layers):
                    x = run(x, pair_kind(j))
                skips.append(x)
                x = _phase_max_pool_nchw(x)
            else:
                for _ in range(self.conv_layers):
                    x = run(x)
                skips.append(x)
                x = F.max_pool2d(x, 2, 2)

        for _ in range(self.conv_layers):
            x = run(x)
        if self.training:
            keep = unet_lib.dropout_mask(x, generator)
            x = torch.where(keep, x / (1.0 - DROPOUT_RATE), x.new_zeros(()))

        x_form = "scalar"
        for L in reversed(range(self.pool_layers)):
            feats = self.start_neurons * 2**L
            if L < lv:
                if x_form == "s2d":
                    x = _d2s_nchw(x)
                x = run(x, "C", presum=True)
                x = torch.cat([x, skips[L]], dim=1)
                perm = _split_concat_perm(feats, feats)
                for j in range(self.conv_layers):
                    x = run(x, pair_kind(j), in_perm=perm if j == 0 else None)
                x_form = "s2d"
            else:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                x = run(x)
                x = torch.cat([x, skips[L]], dim=1)
                for _ in range(self.conv_layers):
                    x = run(x)
                x_form = "scalar"

        hw, hb = self.head.weight, self.head.bias
        x = x.to(hw.dtype)
        if x_form == "s2d":
            eye = torch.eye(4, dtype=hw.dtype, device=hw.device)
            W2 = torch.kron(eye, hw[:, :, 0, 0])[:, :, None, None]
            y = _d2s_nchw(F.conv2d(x, W2, hb.repeat(4)))
        else:
            y = F.conv2d(x, hw, hb)
        return torch.softmax(y, dim=1).permute(0, 2, 3, 1)
