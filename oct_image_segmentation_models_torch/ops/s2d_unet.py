"""Space-to-depth (s2d) U-Net inference forward, counterpart of the JAX
package's ``ops/s2d_unet.py``.

The top ``s2d_levels`` U-Net levels run in a space-to-depth(2) form,
``(B, H/2, W/2, 4C)`` with channel layout ``(q_h, q_w, c)`` where ``q``
are the 2x2 pixel phases. Every stride-1 conv with taps in [-1, 1] per
axis becomes a dense 2x2 conv in block space by alternating the block
alignment of the activations:

- "unshifted" alignment U: block ``i`` holds rows ``{2i, 2i+1}``;
- "shifted" alignment S: block ``i`` holds rows ``{2i-1, 2i}`` (H/2 + 1
  blocks, covering the SAME-padding rows -1 and H).

A 3x3 conv maps U -> S and S -> U with a 2x2 block kernel; the decoder's
2x2 conv maps U -> U; the 1x1 head is a block-diagonal U -> U kernel.
With ``conv_layers`` even, max-pool is a max over the phase channels and
the decoder's nearest-neighbour upsample is folded into its conv kernel.

The weight transform is plain numpy, ported line for line from the JAX
module so that the transformed kernels are bit-equal to JAX's. It reads
the BN-folded weights of the port's :class:`..models.unet.UNetModule`.
The forward (:class:`S2DUNet`) runs the convs through PyTorch in NCHW
with the channel order ``(q_h, q_w, c)``; its public inputs and outputs
keep the JAX layouts. An eligible encoder level can run through the
fused encoder-pair kernel (:mod:`.s2d_enc_pair`, ``fuse_enc_pairs=True``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import float32_precision
from ..models.unet import UNetModule, _same_pads, fold_batchnorm_variables

__all__ = [
    "S2DUNet",
    "build_s2d_apply",
    "d2s",
    "maybe_build_s2d_apply",
    "phase_concat",
    "phase_max_pool",
    "phase_tile",
    "s2d",
    "s2d_eligible_levels",
    "transform_kernel",
]


def maybe_build_s2d_apply(module, output: str = "probs"):
    """The s2d forward of ``module`` when it qualifies.

    The model must be a :class:`UNetModule` with an eligible config.
    Returns ``(S2DUNet | None, spatial_divisor)``: inputs whose H/W are not
    multiples of the divisor must use the plain forward instead.
    """
    if not isinstance(module, UNetModule):
        return None, 1
    hp = module.hparams
    levels = s2d_eligible_levels(
        hp["start_neurons"],
        hp["pool_layers"],
        hp["conv_layers"],
        hp["enc_kernel"],
        hp["dec_kernel"],
    )
    if levels == 0:
        return None, 1
    return build_s2d_apply(module, s2d_levels=levels, output=output), 2**levels


# ---------------------------------------------------------------------------
# Kernel transformation (numpy, as in the JAX module)
# ---------------------------------------------------------------------------


def _tap_range(k: int) -> tuple[int, int]:
    """Input-row offsets of a stride-1 TF-SAME conv with kernel size k."""
    lo = -((k - 1) // 2)
    return lo, lo + k - 1


def _axis_spec(k: int, a_in: int, a_out: int):
    """Block-space geometry for one spatial axis.

    ``a_in``/``a_out``: 0 = unshifted (block i phase q -> row 2i+q),
    1 = shifted (row 2i+q-1). Returns (e_min, e_max), the window of
    input blocks ``i+e`` feeding output block ``i``.
    """
    t_lo, t_hi = _tap_range(k)
    s = a_out - a_in
    # dh = 2e + q - d + s  with q, d in {0,1}; dh must lie in [t_lo, t_hi]
    e_min = -(-(t_lo - 1 - s) // 2)  # ceil((t_lo - 1 - s) / 2)
    e_max = (t_hi + 1 - s) // 2
    return e_min, e_max


def _transform_maps(kh: int, kw: int, a_in: int, a_out: int):
    """Static geometry of a kernel transform: gather indices + validity.

    Returns ``(KI, KJ, mask, e_h_range, e_w_range)`` with KI/KJ/mask of
    shape (Eh, Ew, 2, 2, 2, 2), axes (e_h, e_w, q_h, q_w, d_h, d_w), such
    that ``W2[e,(q,c),(d,n)] = w[KI, KJ][c, n] * mask``.
    """
    ehmin, ehmax = _axis_spec(kh, a_in, a_out)
    ewmin, ewmax = _axis_spec(kw, a_in, a_out)
    Eh, Ew = ehmax - ehmin + 1, ewmax - ewmin + 1
    lo_h, _ = _tap_range(kh)
    lo_w, _ = _tap_range(kw)
    s = a_out - a_in
    KI = np.zeros((Eh, Ew, 2, 2, 2, 2), np.int64)
    KJ = np.zeros((Eh, Ew, 2, 2, 2, 2), np.int64)
    mask = np.zeros((Eh, Ew, 2, 2, 2, 2), bool)
    for ei, e_h in enumerate(range(ehmin, ehmax + 1)):
        for ej, e_w in enumerate(range(ewmin, ewmax + 1)):
            for q_h in range(2):
                for q_w in range(2):
                    for d_h in range(2):
                        for d_w in range(2):
                            ki = 2 * e_h + q_h - d_h + s - lo_h
                            kj = 2 * e_w + q_w - d_w + s - lo_w
                            if 0 <= ki < kh and 0 <= kj < kw:
                                KI[ei, ej, q_h, q_w, d_h, d_w] = ki
                                KJ[ei, ej, q_h, q_w, d_h, d_w] = kj
                                mask[ei, ej, q_h, q_w, d_h, d_w] = True
    return KI, KJ, mask, (ehmin, ehmax), (ewmin, ewmax)


def transform_kernel(w: np.ndarray, a_in: int, a_out: int):
    """Transform a (kh, kw, C, N) stride-1 SAME conv kernel into block
    space: returns (W2, e_h_range, e_w_range) where W2 has shape
    (Eh, Ew, 4C, 4N), channel layout (q_h, q_w, c) / (d_h, d_w, n).
    """
    kh, kw, C, N = w.shape
    KI, KJ, mask, e_h, e_w = _transform_maps(kh, kw, a_in, a_out)
    # (Eh, Ew, qh, qw, dh, dw, C, N) -> (Eh, Ew, qh, qw, C, dh, dw, N)
    W2 = np.asarray(w)[KI, KJ] * mask[..., None, None]
    W2 = np.transpose(W2, (0, 1, 2, 3, 6, 4, 5, 7))
    Eh, Ew = KI.shape[:2]
    return W2.reshape(Eh, Ew, 4 * C, 4 * N), e_h, e_w


def _block_pad(n_in: int, n_out: int, e_rng: tuple[int, int]):
    """(lo, hi) padding of one block axis: output block i reads input
    blocks i+e, e in e_rng; representation sizes n_in -> n_out."""
    e_min, e_max = e_rng
    pad_lo = max(0, -e_min)
    E = e_max - e_min + 1
    pad_hi = n_out - n_in - pad_lo + E - 1
    if pad_hi < 0:
        raise ValueError(f"negative block padding for {(n_in, n_out, e_rng)}")
    return (pad_lo, pad_hi)


def _split_concat_perm(ca: int, cb: int) -> np.ndarray:
    """Input-channel gather map for a transformed kernel whose input is
    ``concat([A_s2d, B_s2d])`` (two phase-major blocks of 4*ca and 4*cb
    channels) instead of the phase-interleaved s2d form of
    ``concat([A, B])`` the transform assumes.

    Returns ``perm`` with ``W2_split[..., p, :] = W2[..., perm[p], :]``.
    """
    c = ca + cb
    perm = np.empty(4 * c, np.int64)
    for q in range(4):
        perm[q * ca : (q + 1) * ca] = q * c + np.arange(ca)
        perm[4 * ca + q * cb : 4 * ca + (q + 1) * cb] = (
            q * c + ca + np.arange(cb)
        )
    return perm


def s2d_eligible_levels(
    start_neurons: int,
    pool_layers: int,
    conv_layers: int,
    enc_kernel: Sequence[int],
    dec_kernel: Sequence[int],
) -> int:
    """How many top levels the transform applies to: an even, non-zero
    number of encoder convs per level and every kernel dim <= 3; a level
    qualifies while ``4 * channels <= 256``."""
    if conv_layers < 1 or conv_layers % 2 != 0:
        # conv_layers=0 has no post-concat conv to bake the decoder's
        # _split_concat_perm into.
        return 0
    if max(tuple(enc_kernel) + tuple(dec_kernel)) > 3:
        return 0
    n = 0
    while n < pool_layers and start_neurons * (2**n) * 4 <= 256:
        n += 1
    return n


# ---------------------------------------------------------------------------
# s2d-domain ops, public layout (B, H, W, C)
# ---------------------------------------------------------------------------


def s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> unshifted (B, H/2, W/2, 4C), layout (q_h, q_w, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def d2s(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d` (input must be unshifted)."""
    B, Hb, Wb, C4 = x.shape
    C = C4 // 4
    x = x.reshape(B, Hb, Wb, 2, 2, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 2 * Hb, 2 * Wb, C)


def phase_max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max-pool of an unshifted s2d tensor = max over the
    phase channels; returns a scalar-form (B, Hb, Wb, C) tensor."""
    B, Hb, Wb, C4 = x.shape
    return x.reshape(B, Hb, Wb, 4, C4 // 4).amax(dim=3)


def phase_tile(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample in s2d form: scalar (B, Hb, Wb, C)
    -> unshifted (B, Hb, Wb, 4C) with all 4 phases equal."""
    B, Hb, Wb, C = x.shape
    return x[:, :, :, None, :].expand(B, Hb, Wb, 4, C).reshape(B, Hb, Wb, 4 * C)


def phase_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel-concat of two unshifted s2d tensors, interleaved per phase
    so the result is the s2d form of ``concat([A, B], axis=-1)``. (The
    forward uses a plain concat and :func:`_split_concat_perm` instead.)"""
    B, Hb, Wb, Ca4 = a.shape
    Cb4 = b.shape[-1]
    a = a.reshape(B, Hb, Wb, 4, Ca4 // 4)
    b = b.reshape(B, Hb, Wb, 4, Cb4 // 4)
    return torch.cat([a, b], dim=-1).reshape(B, Hb, Wb, Ca4 + Cb4)


def _mask_shifted(y: torch.Tensor) -> torch.Tensor:
    """Zero the phases of a shifted (B, Nh, Nw, 4C) tensor that stand for
    original row -1 / row H (phase q_h=0 of block 0, q_h=1 of the last
    block) and the same for columns: the SAME padding zeros the next conv
    reads."""
    B, Nh, Nw, C4 = y.shape
    m = _shifted_keep(Nh, Nw, y.device)  # (2, 2, Nh, Nw)
    y = y.reshape(B, Nh, Nw, 2, 2, C4 // 4)
    m = m.permute(2, 3, 0, 1)[None, :, :, :, :, None]
    return torch.where(m, y, torch.zeros((), dtype=y.dtype)).reshape(B, Nh, Nw, C4)


def _conv_block_space(x, W2, bias4, e_h, e_w, n_out_h, n_out_w):
    """One transformed conv in block space + bias, public layout: x
    (B, nh, nw, 4Cin), W2 (Eh, Ew, 4Cin, 4Cout) -> (B, n_out_h, n_out_w,
    4Cout)."""
    pads = _conv_pads(x.shape[1], x.shape[2], e_h, e_w, n_out_h, n_out_w)
    y = _conv_nchw(
        x.permute(0, 3, 1, 2), W2.permute(3, 2, 0, 1), bias4, pads
    )
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# NCHW helpers of the forward; channel order (q_h, q_w, c) as above
# ---------------------------------------------------------------------------


def _s2d_nchw(x: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, 4 * C, H // 2, W // 2)


def _d2s_nchw(x: torch.Tensor) -> torch.Tensor:
    B, C4, Hb, Wb = x.shape
    C = C4 // 4
    x = x.reshape(B, 2, 2, C, Hb, Wb).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C, 2 * Hb, 2 * Wb)


def _shifted_keep(nh: int, nw: int, device) -> torch.Tensor:
    """(2, 2, nh, nw) bool: which (q_h, q_w) phase of a shifted block is a
    real pixel (not row -1 / H or column -1 / W)."""
    ih = torch.arange(nh, device=device)
    iw = torch.arange(nw, device=device)
    row_ok = torch.stack([ih != 0, ih != nh - 1])  # (2, nh)
    col_ok = torch.stack([iw != 0, iw != nw - 1])  # (2, nw)
    return row_ok[:, None, :, None] & col_ok[None, :, None, :]


def _mask_shifted_nchw(y: torch.Tensor) -> torch.Tensor:
    B, C4, nh, nw = y.shape
    m = _shifted_keep(nh, nw, y.device)[:, :, None]  # (2, 2, 1, nh, nw)
    y = y.reshape(B, 2, 2, C4 // 4, nh, nw)
    return torch.where(m, y, torch.zeros((), dtype=y.dtype)).reshape(B, C4, nh, nw)


def _conv_pads(nh, nw, e_h, e_w, n_out_h, n_out_w):
    """``F.pad`` amounts (w_lo, w_hi, h_lo, h_hi) of a block-space conv."""
    ph = _block_pad(nh, n_out_h, e_h)
    pw = _block_pad(nw, n_out_w, e_w)
    return (pw[0], pw[1], ph[0], ph[1])


def _conv_nchw(x, w_oihw, bias, pads):
    """Asymmetric zero padding, then a VALID conv + bias."""
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w_oihw, bias)


def _phase_max_pool_nchw(x: torch.Tensor) -> torch.Tensor:
    """:func:`phase_max_pool` in NCHW: (B, 4C, Hb, Wb) -> (B, C, Hb, Wb)."""
    B, C4, hb, wb = x.shape
    return x.reshape(B, 4, C4 // 4, hb, wb).amax(dim=1)


def _enc_pair_nchw(x, w1_oihw, b1, w2_oihw, b2):
    """One standard s2d encoder level in NCHW, unfused: conv U -> S (block
    taps e in {-1, 0}) + ReLU + shifted-edge masks, conv S -> U (e in
    {0, 1}) + ReLU, phase max-pool. Returns ``(y2, pooled)``."""
    _, _, nh, nw = x.shape
    pads1 = _conv_pads(nh, nw, (-1, 0), (-1, 0), nh + 1, nw + 1)
    y1 = _mask_shifted_nchw(F.relu(_conv_nchw(x, w1_oihw, b1, pads1)))
    pads2 = _conv_pads(nh + 1, nw + 1, (0, 1), (0, 1), nh, nw)
    y2 = F.relu(_conv_nchw(y1, w2_oihw, b2, pads2))
    return y2, _phase_max_pool_nchw(y2)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class _Conv:
    """One conv of the plan: its weight/bias buffer names and geometry.
    ``kind`` is "s2d" (block space, alignments ``a_in`` -> ``a_out``) or
    "plain" (stride-1 SAME conv of kernel ``kernel``)."""

    def __init__(self, kind, name, e_h=None, e_w=None, a_in=0, a_out=0, kernel=None):
        self.kind = kind
        self.name = name
        self.e_h, self.e_w = e_h, e_w
        self.a_in, self.a_out = a_in, a_out
        self.kernel = kernel


class S2DUNet(nn.Module):
    """The s2d forward of a :class:`UNetModule`, counterpart of JAX
    ``build_s2d_apply``'s ``apply_fn``. Built by :func:`build_s2d_apply`.

    ``forward(x)``: preprocessed ``(B, H, W, Cin)`` float images ->
    ``output`` "probs" (B, H, W, K) float32 softmax, "labels" (B, H, W)
    uint8 argmax, or "labels_s2d" (B, H/2, W/2, 4) uint8 argmax in s2d
    layout (channel order (q_h, q_w)). Softmax and argmax run per phase
    group; argmax takes the first class on ties.
    """

    def __init__(
        self,
        module: UNetModule,
        s2d_levels: Optional[int] = None,
        output: str = "probs",
        fuse_enc_pairs="auto",
    ):
        super().__init__()
        if output not in ("probs", "labels", "labels_s2d"):
            raise ValueError(f"unknown output mode: {output}")
        hp = module.hparams
        pool_layers, conv_layers = hp["pool_layers"], hp["conv_layers"]
        enc_kernel, dec_kernel = hp["enc_kernel"], hp["dec_kernel"]
        if s2d_levels is None:
            s2d_levels = s2d_eligible_levels(
                hp["start_neurons"], pool_layers, conv_layers, enc_kernel, dec_kernel
            )
        if output == "labels_s2d" and s2d_levels == 0:
            raise ValueError("labels_s2d output requires s2d_levels > 0")
        if fuse_enc_pairs == "auto":
            # Off, as in JAX: the fused kernel is a choice made by measuring.
            fuse_enc_pairs = False
        self.output = output
        self.s2d_levels = s2d_levels
        self.pool_layers = pool_layers
        self.fuse_enc_pairs = bool(fuse_enc_pairs)

        # Folded weights in module creation order, as HWIO numpy float32.
        state = {
            k: v.detach().cpu()
            for k, v in fold_batchnorm_variables(module.state_dict()).items()
        }
        n_blocks = (
            pool_layers * conv_layers + conv_layers + pool_layers * (1 + conv_layers)
        )
        convs = []
        for i in range(n_blocks):
            w = state[f"blocks.{i}.conv.weight"].numpy()
            convs.append(
                (
                    np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                    state[f"blocks.{i}.conv.bias"].numpy(),
                )
            )
        head_k = np.ascontiguousarray(
            state["head.weight"].numpy().transpose(2, 3, 1, 0)
        )
        head_b = state["head.bias"].numpy()

        self._n = 0

        def add(w_hwio, b, kind, **geom):
            """Register the conv's weights as buffers and return its plan."""
            name = f"c{self._n}"
            self._n += 1
            self.register_buffer(
                f"{name}_w",
                torch.from_numpy(np.ascontiguousarray(w_hwio))
                .to(torch.float32)
                .permute(3, 2, 0, 1)
                .contiguous(),
            )
            self.register_buffer(f"{name}_b", torch.from_numpy(np.asarray(b, np.float32)))
            return _Conv(kind, name, **geom)

        def t(w, b, a_in, a_out, in_perm=None):
            W2, e_h, e_w = transform_kernel(w, a_in, a_out)
            if in_perm is not None:
                W2 = W2[:, :, in_perm, :]
            return add(
                W2, np.tile(b, 4), "s2d", e_h=e_h, e_w=e_w, a_in=a_in, a_out=a_out
            )

        def plain(w, b):
            return add(w, b, "plain", kernel=w.shape[:2])

        idx = 0
        self.enc_plan = []
        for L in range(pool_layers):
            level = []
            for j in range(conv_layers):
                w, b = convs[idx]
                idx += 1
                if L < s2d_levels:
                    a_in, a_out = (0, 1) if j % 2 == 0 else (1, 0)
                    level.append(t(w, b, a_in, a_out))
                else:
                    level.append(plain(w, b))
            self.enc_plan.append(level)

        self.bot_plan = []
        for j in range(conv_layers):
            w, b = convs[idx]
            idx += 1
            self.bot_plan.append(plain(w, b))

        self.dec_plan = []  # iterated as L = pool_layers-1 .. 0
        for L in reversed(range(pool_layers)):
            level = []
            w, b = convs[idx]
            idx += 1
            if L < s2d_levels:
                # The dec conv (U -> U) reads the phase-tiled upsample,
                # whose 4 phases are equal: sum its kernel over the input
                # phase axis and feed the scalar-form x directly.
                W2, e_h, e_w = transform_kernel(w, 0, 0)
                cin = w.shape[2]
                W2 = W2.reshape(W2.shape[0], W2.shape[1], 4, cin, W2.shape[3]).sum(
                    axis=2
                )
                level.append(add(W2, np.tile(b, 4), "s2d", e_h=e_h, e_w=e_w))
            else:
                level.append(plain(w, b))
            for j in range(conv_layers):
                w, b = convs[idx]
                idx += 1
                if L < s2d_levels:
                    a_in, a_out = (0, 1) if j % 2 == 0 else (1, 0)
                    # The first conv reads the plain concat [x, skip] of
                    # two phase-major blocks; the interleave is baked
                    # into its kernel.
                    perm = None
                    if j == 0:
                        feats = w.shape[3]
                        perm = _split_concat_perm(feats, w.shape[2] - feats)
                    level.append(t(w, b, a_in, a_out, in_perm=perm))
                else:
                    level.append(plain(w, b))
            self.dec_plan.append((L, level))

        if s2d_levels > 0:
            # head as a block-diagonal 1x1 U -> U kernel
            C, K = head_k.shape[2], head_k.shape[3]
            hk = np.zeros((1, 1, 4 * C, 4 * K), np.float64)
            for q in range(4):
                hk[0, 0, q * C : (q + 1) * C, q * K : (q + 1) * K] = head_k[0, 0]
            self.head = add(hk, np.tile(head_b, 4), "s2d", e_h=(0, 0), e_w=(0, 0))
        else:
            self.head = add(head_k, head_b, "plain", kernel=(1, 1))

        # The fused kernel takes its weights HWIO (2, 2, 4Cin, 4C).
        self._fused_levels = {}
        if self.fuse_enc_pairs:
            for L, level in enumerate(self.enc_plan):
                if self._pair_shape_ok(level):
                    names = []
                    for conv in level:
                        w = getattr(self, f"{conv.name}_w").permute(2, 3, 1, 0)
                        self.register_buffer(f"{conv.name}_hwio", w.contiguous())
                        names.append(conv.name)
                    self._fused_levels[L] = names
        self.to(module.head.weight.device)

    @staticmethod
    def _pair_shape_ok(level) -> bool:
        """The level is the standard U -> S -> U pair of s2d convs."""
        return (
            len(level) == 2
            and all(c.kind == "s2d" for c in level)
            and (level[0].a_in, level[0].a_out) == (0, 1)
            and (level[1].a_in, level[1].a_out) == (1, 0)
        )

    def _w(self, conv):
        return getattr(self, f"{conv.name}_w"), getattr(self, f"{conv.name}_b")

    def _run(self, x, conv):
        w, b = self._w(conv)
        if conv.kind == "plain":
            y = _conv_nchw(x, w, b, _same_pads(conv.kernel))
            return F.relu(y)
        _, _, nh, nw = x.shape
        n_out_h = nh + (conv.a_out - conv.a_in)
        n_out_w = nw + (conv.a_out - conv.a_in)
        pads = _conv_pads(nh, nw, conv.e_h, conv.e_w, n_out_h, n_out_w)
        y = F.relu(_conv_nchw(x, w, b, pads))
        if conv.a_out == 1:
            y = _mask_shifted_nchw(y)
        return y

    def _try_fused_enc(self, x, L):
        """The fused encoder pair when the level is eligible: returns
        (skip, pooled) in NCHW, or None for the unfused ops."""
        names = self._fused_levels.get(L)
        if names is None:
            return None
        from .s2d_enc_pair import enc_pair_supported, fused_enc_pair

        _, cin4, nh, nw = x.shape
        w1 = getattr(self, f"{names[0]}_hwio")
        if not enc_pair_supported(nh, nw, cin4, w1.shape[-1]):
            return None
        y2, pooled = fused_enc_pair(
            x.permute(0, 2, 3, 1).contiguous(),
            w1,
            getattr(self, f"{names[0]}_b"),
            getattr(self, f"{names[1]}_hwio"),
            getattr(self, f"{names[1]}_b"),
        )
        return y2.permute(0, 3, 1, 2), pooled.permute(0, 3, 1, 2).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with float32_precision():
            return self._forward(x)

    def _forward(self, x):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        skips = []
        for L in range(self.pool_layers):
            if L < self.s2d_levels:
                if x.shape[2] % 2 or x.shape[3] % 2:
                    raise ValueError(
                        "s2d inference path needs even spatial dims; pass "
                        "s2d_levels=0 for odd sizes"
                    )
                x = _s2d_nchw(x)
                fused = self._try_fused_enc(x, L)
                if fused is not None:
                    skip, x = fused
                    skips.append(skip)
                    continue
                for conv in self.enc_plan[L]:
                    x = self._run(x, conv)
                skips.append(x)  # s2d unshifted form
                x = _phase_max_pool_nchw(x)
            else:
                for conv in self.enc_plan[L]:
                    x = self._run(x, conv)
                skips.append(x)
                x = F.max_pool2d(x, 2, 2)

        for conv in self.bot_plan:
            x = self._run(x, conv)

        x_form = "scalar"
        for L, level in self.dec_plan:
            if L < self.s2d_levels:
                if x_form == "s2d":
                    x = _d2s_nchw(x)
                x = self._run(x, level[0])
                x = torch.cat([x, skips[L]], dim=1)
                for conv in level[1:]:
                    x = self._run(x, conv)
                x_form = "s2d"
            else:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                x = self._run(x, level[0])
                x = torch.cat([x, skips[L]], dim=1)
                for conv in level[1:]:
                    x = self._run(x, conv)
                x_form = "scalar"

        w, b = self._w(self.head)
        y = F.conv2d(x, w, b)
        if x_form == "s2d":
            # Per-phase class groups (B, 4, K, Hb, Wb): softmax and argmax
            # commute with the d2s permutation.
            B, C4, hb, wb = y.shape
            k = C4 // 4
            yg = y.reshape(B, 4, k, hb, wb)
            probs = torch.softmax(yg, dim=2)
            if self.output in ("labels", "labels_s2d"):
                lab = torch.argmax(probs, dim=2).to(torch.uint8)  # (B, 4, hb, wb)
                lab = lab.permute(0, 2, 3, 1)
                if self.output == "labels_s2d":
                    return lab.contiguous()
                return d2s(lab)[..., 0]
            probs = probs.reshape(B, 2, 2, k, hb, wb).permute(0, 4, 1, 5, 2, 3)
            return probs.reshape(B, 2 * hb, 2 * wb, k)
        probs = torch.softmax(y, dim=1).permute(0, 2, 3, 1)
        if self.output == "labels":
            return torch.argmax(probs, dim=-1).to(torch.uint8)
        return probs


def build_s2d_apply(
    module: UNetModule,
    *,
    s2d_levels: Optional[int] = None,
    output: str = "probs",
    fuse_enc_pairs="auto",
) -> S2DUNet:
    """The s2d forward of ``module`` (BN folded first when it has BN), in
    eval mode on the module's device. ``s2d_levels`` defaults to
    :func:`s2d_eligible_levels`; 0 runs every level as plain convs.
    ``fuse_enc_pairs=True`` runs each eligible encoder level through the
    fused encoder-pair kernel; ``"auto"`` means off, as in JAX."""
    return S2DUNet(
        module, s2d_levels=s2d_levels, output=output, fuse_enc_pairs=fuse_enc_pairs
    ).eval()
