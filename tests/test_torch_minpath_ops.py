"""The min-path kernels as registered operators (``ops/minpath_ops.py``):
on CPU tensors ``torch.ops.octseg.minpath_delineate[_s2d]`` is the plain
version bit for bit, its fake implementation gives the output's shape
under a symbolic batch, and ``minpath.delineate[_s2d]`` reach the
operator, never the kernel's ``ctypes`` call. The card's half of the same
checks is in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oct_image_segmentation_models_torch.ops import minpath, minpath_cuda
from oct_image_segmentation_models_torch.ops.boundary import image_maps_to_s2d

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

OPS = {
    "image": ("octseg.minpath_delineate.default", minpath.delineate),
    "s2d": ("octseg.minpath_delineate_s2d.default", minpath.delineate_s2d),
}


class OpRecorder(TorchDispatchMode):
    """The names of the operators that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _maps(seed, n=3, w=40, h=24):
    rng = np.random.default_rng(seed)
    maps = rng.integers(0, 256, (n, w, h), dtype=np.uint8)
    maps[0] = 0  # every row tied
    maps[1, :, 5:9] = 255  # a wide plateau
    return torch.from_numpy(maps)


def _s2d(maps):
    """``(N, W, H)`` transposed maps -> s2d maps ``(1, N, H/2, W/2, 4)``."""
    return image_maps_to_s2d(maps.transpose(-1, -2)[None]).contiguous()


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
@pytest.mark.parametrize("max_grad", [1, 2])
def test_operators_equal_the_plain_version_on_the_cpu(tie_parity, max_grad):
    maps = _maps(max_grad)
    exact = tie_parity == "exact"
    got = torch.ops.octseg.minpath_delineate(maps, max_grad, exact)
    want = minpath.delineate_reference(maps, max_grad=max_grad, tie_parity=tie_parity)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    s2d = _s2d(maps)
    got = torch.ops.octseg.minpath_delineate_s2d(s2d, max_grad, exact)
    want_s2d = minpath.delineate_s2d_reference(s2d, max_grad=max_grad, tie_parity=tie_parity)
    assert torch.equal(got, want_s2d) and torch.equal(got[0], want)


@pytest.mark.parametrize("layout", ["image", "s2d"])
@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
def test_delineate_reaches_the_operator(layout, tie_parity, monkeypatch):
    """``backend="auto"`` on a CPU tensor runs the operator alone (its CPU
    implementation is the plain version); ``"reference"`` runs the plain
    version's ATen ops directly; neither touches the kernel's wrapper."""

    def no_kernel(*args, **kwargs):
        raise AssertionError("the ctypes launch was reached")

    monkeypatch.setattr(minpath_cuda, "_launch", no_kernel)
    op, fn = OPS[layout]
    maps = _maps(7) if layout == "image" else _s2d(_maps(7))
    with OpRecorder() as rec:
        got = fn(maps, tie_parity=tie_parity)
    assert rec.ops == [op]
    with OpRecorder() as rec:
        want = fn(maps, tie_parity=tie_parity, backend="reference")
    assert op not in rec.ops and len(rec.ops) > 10
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["image", "s2d"])
def test_fake_implementation_under_a_symbolic_batch(layout):
    """Traced with a symbolic batch, the operator's output keeps the batch
    symbol and the static sizes: ``(N, W)`` and ``(B, M, 2 Wb)``."""
    op, fn = OPS[layout]

    class Delineate(torch.nn.Module):
        def forward(self, maps):
            return fn(maps, tie_parity="fast")

    maps = _maps(3) if layout == "image" else _s2d(_maps(3)).expand(2, -1, -1, -1, -1)
    program = torch.export.export(
        Delineate(), (maps.contiguous(),),
        dynamic_shapes=({0: torch.export.Dim("batch", min=1)},),
    )
    (node,) = [n for n in program.graph.nodes if str(n.target) == op]
    shape = node.meta["val"].shape
    assert isinstance(shape[0], torch.SymInt)
    if layout == "image":
        assert tuple(shape[1:]) == (40,)
    else:
        assert tuple(shape[1:]) == (3, 40)
    for batch in (1, 3):
        x = maps[:1].expand(batch, *maps.shape[1:]).contiguous()
        assert torch.equal(program.module()(x), fn(x, tie_parity="fast"))


def test_operator_argument_checks():
    maps = _maps(0)
    with pytest.raises(ValueError, match="tie_parity"):
        minpath.delineate(maps, tie_parity="slow")
    with pytest.raises(ValueError, match="packing limit"):
        minpath.delineate(maps, max_grad=31)
