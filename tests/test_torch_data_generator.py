"""The port's host batch generation and device augmentations against the
JAX package's.

``DataGenerator`` is a numpy copy: with the same seed its batches, its
augmentation choices and its ``get_state`` must equal JAX's bit for bit,
in the modes none, one and all, on the fly and precomputed, with host and
device augmentation. The device flips must equal JAX's exactly; the
device noise comes from a ``torch.Generator``, not JAX's stream, so its
mean and variance are held within a band: for n = 65536 draws of
N(mean, var), the sample mean within 5 * sqrt(var / n) of the mean and the
sample variance within 3% of var.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common import augmentation as jax_aug
from oct_image_segmentation_models_tpu.common import data_generator as jax_gen
from oct_image_segmentation_models_tpu.ops import augment as jax_device_aug
from oct_image_segmentation_models_torch.common import augmentation as port_aug
from oct_image_segmentation_models_torch.common import data_generator as port_gen
from oct_image_segmentation_models_torch.ops import augment as port_device_aug

from synth import make_layered_sample
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

N, H, W, C = 7, 16, 24, 3
AUGMENTATIONS = [
    ("flip", {"flip_type": "left-right"}),
    ("add_noise", {"mode": "gaussian", "mean": 0.0, "variance": 0.01}),
    ("flip", {"flip_type": "up-down"}),
]


def _data():
    rng = np.random.default_rng(3)
    images, labels = [], []
    for _ in range(N):
        img, lab, _ = make_layered_sample(rng, H, W, C)
        images.append(img)
        labels.append(lab)
    return np.stack(images)[..., None], np.stack(labels)[..., None]


def _aug_fn_args(module):
    return [(module.augmentation_map[name], dict(arg)) for name, arg in AUGMENTATIONS]


def _generators(mode, fly, device, probs=()):
    images, labels = _data()
    kwargs = dict(
        images=images, labels=labels, batch_size=3, aug_mode=mode, aug_probs=probs,
        aug_fly=fly, preprocess_input_fn=lambda x: x / 255.0, shuffle=True, seed=21,
        aug_device=device,
    )
    return (
        jax_gen.DataGenerator(aug_fn_args=_aug_fn_args(jax_aug), **kwargs),
        port_gen.DataGenerator(aug_fn_args=_aug_fn_args(port_aug), **kwargs),
    )


def _assert_state_equal(a, b):
    assert a["rng_state"] == b["rng_state"]
    np.testing.assert_array_equal(a["sample_shuffle"], b["sample_shuffle"])
    assert a["counters"] == b["counters"]


@pytest.mark.parametrize(
    "mode,fly,device",
    [
        ("none", False, False),
        ("none", True, False),
        ("one", True, False),
        ("one", False, False),
        ("one", True, True),
        ("all", True, False),
        ("all", False, False),
        ("all", True, True),
    ],
)
def test_batches_choices_and_state_bit_equal(mode, fly, device):
    probs = (0.2, 0.5, 0.3) if mode == "one" else ()
    jg, pg = _generators(mode, fly, device, probs)
    assert len(jg) == len(pg) and jg.get_total_samples() == pg.get_total_samples()
    for _ in range(2):  # two epochs: the reshuffle at the epoch end
        for jb, pb in zip(jg, pg):
            assert len(jb) == len(pb) == (3 if device else 2)
            for j, p in zip(jb, pb):
                assert j.dtype == p.dtype and j.shape == p.shape
                np.testing.assert_array_equal(j, p)
        _assert_state_equal(jg.get_state(), pg.get_state())
        jg.on_epoch_end()
        pg.on_epoch_end()
        _assert_state_equal(jg.get_state(), pg.get_state())


def test_set_state_resumes_the_stream():
    jg, pg = _generators("one", True, False, (0.2, 0.5, 0.3))
    for _ in pg:
        pass
    pg.on_epoch_end()
    saved = pg.get_state()
    expected = [np.array(b[0]) for b in pg]
    _, resumed = _generators("one", True, False, (0.2, 0.5, 0.3))
    resumed.set_state(saved)
    for want, got in zip(expected, resumed):
        np.testing.assert_array_equal(got[0], want)


def test_generator_validation_matches_jax():
    images, labels = _data()
    bad = [
        dict(aug_mode="sideways"),
        dict(aug_mode="one", aug_fn_args=[]),
        dict(aug_mode="one", aug_probs=(0.5,)),
        dict(aug_mode="one", aug_probs=(0.5, 0.2, 0.2)),
        dict(aug_device=True, aug_fly=False),
    ]
    for kw in bad:
        for module, augs in ((jax_gen, jax_aug), (port_gen, port_aug)):
            args = dict(
                images=images, labels=labels, batch_size=2, aug_fn_args=_aug_fn_args(augs),
                aug_mode="none", aug_probs=(), aug_fly=True, preprocess_input_fn=lambda x: x,
            )
            args.update(kw)
            with pytest.raises(ValueError):
                module.DataGenerator(**args)


def test_host_augmentations_equal():
    img = _data()[0][0] / 255.0
    for name, arg in AUGMENTATIONS + [("add_noise", {"mode": "s&p", "variance": 0.1})]:
        j = jax_aug.augmentation_map[name](img, img[..., 0], dict(arg, rng=np.random.default_rng(1)))
        p = port_aug.augmentation_map[name](img, img[..., 0], dict(arg, rng=np.random.default_rng(1)))
        for a, b in zip(j, p):
            np.testing.assert_array_equal(a, b)
        assert jax_aug.augmentation_map[name](None, None, arg, True) == port_aug.augmentation_map[
            name
        ](None, None, arg, True)


@pytest.mark.parametrize("flip_type", ["up-down", "left-right"])
def test_device_flip_exact(flip_type):
    images, labels = _data()
    x = (images / 255.0).astype(np.float32)
    jx, jl = jax_device_aug.flip(jnp.asarray(x), jnp.asarray(labels), flip_type)
    px, pl = port_device_aug.flip(torch.from_numpy(x), torch.from_numpy(labels), flip_type)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    with pytest.raises(ValueError, match="Unknown flip_type"):
        port_device_aug.flip(px, pl, "diagonal")


def _check_noise_band(noise, mean, variance):
    n = noise.size
    assert abs(noise.mean() - mean) <= 5 * np.sqrt(variance / n), noise.mean()
    assert abs(noise.var() - variance) <= 0.03 * variance, noise.var()


@pytest.mark.parametrize("mode", ["gaussian", "speckle"])
def test_device_noise_mean_and_variance(mode):
    """The noise branch of ``build_device_augmenter`` (what the train step
    runs) is the public transform, draw for draw, and its noise lies in
    the band."""
    base = torch.full((4, 128, 128, 1), 0.5)
    labels = torch.zeros((4, 128, 128, 1), dtype=torch.uint8)
    mean, variance = 0.01, 0.004
    apply = port_device_aug.build_device_augmenter(
        [(port_aug.add_noise_aug, {"mode": mode, "mean": mean, "variance": variance})]
    )
    out, out_labels = apply(torch.Generator().manual_seed(0), base, labels, torch.zeros(4, dtype=torch.int32))
    public = {"gaussian": port_device_aug.add_gaussian_noise, "speckle": port_device_aug.add_speckle_noise}
    assert torch.equal(out, public[mode](torch.Generator().manual_seed(0), base, mean, variance))
    assert torch.equal(out_labels, labels)
    noise = (out - base).numpy() if mode == "gaussian" else ((out - base) / base).numpy()
    _check_noise_band(noise.astype(np.float64), mean, variance)
    assert out.min() >= 0 and out.max() <= 1


def test_device_augmenter_selects_per_sample_choices():
    images, labels = _data()
    x = (images / 255.0).astype(np.float32)
    choices = np.array([0, -1, 2, 1, 0, 2, -1], np.int32)
    apply_j = jax_device_aug.build_device_augmenter(_aug_fn_args(jax_aug))
    apply_p = port_device_aug.build_device_augmenter(_aug_fn_args(port_aug))
    jx, jl = apply_j(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(labels), jnp.asarray(choices))
    px, pl = apply_p(
        torch.Generator().manual_seed(0), torch.from_numpy(x), torch.from_numpy(labels),
        torch.from_numpy(choices),
    )
    flips = choices != 1  # the noise branch draws from another stream
    np.testing.assert_array_equal(px.numpy()[flips], np.asarray(jx)[flips])
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    noisy = choices == 1
    noise = (px.numpy()[noisy] - x[noisy]).astype(np.float64)
    assert np.abs(noise).max() > 0 and abs(noise.mean()) < 0.02
    assert port_device_aug.build_device_augmenter(
        [(port_aug.add_noise_aug, {"mode": "salt"})]
    ) is None


def test_random_flip_flips_whole_samples():
    images, labels = _data()
    x = torch.from_numpy((images / 255.0).astype(np.float32))
    y = torch.from_numpy(labels)
    fx, fy = port_device_aug.random_flip(torch.Generator().manual_seed(3), x, y, p=0.5)
    flipped = [bool(torch.equal(fx[i], torch.flip(x[i], (1,)))) for i in range(N)]
    kept = [bool(torch.equal(fx[i], x[i])) for i in range(N)]
    assert all(a or b for a, b in zip(flipped, kept)) and any(flipped) and any(kept)
    for i in range(N):
        assert torch.equal(fy[i], torch.flip(y[i], (1,)) if flipped[i] else y[i])
