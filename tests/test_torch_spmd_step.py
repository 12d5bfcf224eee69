"""The port's ``impl="spmd"`` train and eval steps over two ranks against
JAX's spmd step on a 2-device mesh and against the port's one-device
step on the global batch, on the CPU.

JAX's ``impl="spmd"`` is the one-device step on the global batch: the
concatenation of every rank's rows in rank order, BatchNorm statistics
over all of it, the loss and the metric functions of all of it. The
ranks are gloo processes spawned and joined with a timeout as in
``tests/test_torch_dp_step.py``; each holds 2 rows of a global batch of 4,
at the U-Net and sizes of ``tests/test_torch_train_step.py`` (32x48, 3
classes, start_neurons=2, pool_layers=2), from the port's seeded weights
carried to Flax (``flax_from_state_dict``).

- Against JAX ``make_train_step(impl="spmd")`` on a 2-device virtual CPU
  mesh, the batch sharded over it: 3 Adam steps of focal + Dice loss, each
  rank's dropout mask its rows of JAX's global mask. Loss and metric per
  step rel 1e-5, parameters and statistics as
  ``test_torch_train_step._check_params`` holds them, the spmd eval step
  rel 1e-4.
- Against the port's one-device step on the 4 rows, every rank's
  generator seeded as the one-device step's (the global batch's randoms
  from one stream): 3 Adam steps of ``dice_loss_micro`` (whose sums a
  per-rank mean would get wrong) with the micro-Dice metric, loss, metric
  per step rel 1e-6, parameters and statistics as ``_check_params`` holds
  them, the eval step (which reads the parameters after Adam) rel 1e-5.
  The same for one spmd step of ``S2DTrainForward``.
- One spmd step of a small DeepLabV3+ (48x64) in float64, with a float64
  cross-entropy (the registry's losses compute in float32), against the
  port's own one-device float64 step, which
  ``tests/test_torch_deeplab_training.py`` holds against JAX: loss and
  eval rel 1e-10, gradients within 1e-10 of each tensor's max (the pre-BN
  conv biases, whose exact gradient is 0, of the largest gradient's;
  measured 3.0e-13), statistics within 1e-10 (measured 5.3e-15).
- Both ranks' parameters, statistics and optimizer state bit-equal after
  every case.
- ``train_model(train_step_impl="spmd", train_forward_impl="s2d")`` over
  the two ranks: one epoch, then a resume from its train state to a
  second, against an uninterrupted two-epoch run; both ranks bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import metrics as jm
from oct_image_segmentation_models_tpu.parallel import train_step as jts
from oct_image_segmentation_models_tpu.parallel.mesh import create_mesh as jax_mesh
from oct_image_segmentation_models_tpu.parallel.mesh import shard_batch
from oct_image_segmentation_models_torch.common.model_io import flax_from_state_dict
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops import losses as tl
from oct_image_segmentation_models_torch.ops import metrics as tm
from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward
from oct_image_segmentation_models_torch.parallel import train_step as tts

from synth import make_dataset
from test_torch_dp_step import join_ranks, start_ranks
from test_torch_train_step import (
    CONFIG,
    C,
    H,
    RTOL,
    W,
    _batch,
    _check_params,
    _jax_mask,
    _loss_pair,
    _state_dict_of,
)
import test_torch_deeplab_training as dl
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

STEPS = 3
GLOBAL_BATCH = 4
EVAL_RTOL = 1e-4
ONE_RTOL = 1e-6
F64_TOL = 1e-10
LR = 1e-3
SEED = 11
BOTTLENECK = (CONFIG["start_neurons"] * 4, H // 4, W // 4)

RANK_BODY = """
from oct_image_segmentation_models_torch.models import get_model_class, unet
from oct_image_segmentation_models_torch.ops import losses, metrics
from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward
from oct_image_segmentation_models_torch.parallel import train_step as ts
from oct_image_segmentation_models_torch.training import training

data = np.load(f"{workdir}/inputs.npz")
config = json.loads(str(data["config"]))
rows = mesh.world_rows(int(data["x"].shape[1]))
out, arrays = {}, {}


def cross_entropy64(labels, probs):
    onehot = torch.nn.functional.one_hot(labels[..., 0].long(), probs.shape[-1])
    return -(onehot * torch.log(probs)).sum(-1).mean()


def unet_module():
    module = get_model_class("unet")(**config).build_model(device="cpu")
    module.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")})
    return module


def keep(name, module, state):
    arrays.update({f"{name}/sd/{k}": v.numpy() for k, v in module.state_dict().items()})
    arrays.update({f"{name}/grad/{k}": p.grad.numpy() for k, p in module.named_parameters()})
    for i, p in enumerate(state.optimizer.param_groups[0]["params"]):
        for slot, v in state.optimizer.state[p].items():
            if torch.is_tensor(v):
                arrays[f"{name}/opt/{i}/{slot}"] = v.numpy()


def steps(name, module, loss, metric, batches, generator, ex="ex", ey="ey"):
    state = ts.create_train_state(module, ts.build_optimizer("adam", {}), mesh)
    step = ts.make_train_step(module, loss, metric, mesh, impl="spmd")
    evaluate = ts.make_eval_step(module, loss, metric, mesh, impl="spmd")
    got = []
    for x, y in batches:
        state, lv, mv = step(state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), generator)
        got.append([float(lv), float(mv)])
    el, em = evaluate(state, torch.from_numpy(data[ex][rows]), torch.from_numpy(data[ey][rows]))
    out[name] = {"steps": got, "eval": [float(el), float(em)]}
    keep(name, module, state)


# JAX's global masks, this rank's rows.
masks = [torch.from_numpy(m[rows]) for m in data["masks"]]
real_mask = unet.dropout_mask
unet.dropout_mask = lambda x, generator: masks.pop(0)
focal = losses.focal_dice_loss(num_classes=3)
steps("jax", unet_module(), focal, metrics.dice_coef_macro(True, 3), zip(data["x"], data["y"]), None)
assert not masks
unet.dropout_mask = real_mask

micro = losses.dice_loss_micro(num_classes=3, is_y_true_sparse=True)
micro_metric = metrics.dice_coef_micro(True, 3)
gen = torch.Generator().manual_seed(int(data["seed"]))
steps("one", unet_module(), micro, micro_metric, zip(data["x"], data["y"]), gen)

module = unet_module()
steps("s2d", S2DTrainForward(module), micro, micro_metric, zip(data["x"][:1], data["y"][:1]),
      torch.Generator().manual_seed(int(data["seed"])))

dl_module = get_model_class("deeplabv3plus")(**json.loads(str(data["dl_config"]))).build_model(
    generator=torch.Generator().manual_seed(3), device="cpu").double()
steps("deeplab", dl_module, cross_entropy64, cross_entropy64,
      [(data["dl_x"], data["dl_y"])], torch.Generator().manual_seed(int(data["seed"])),
      "dl_ex", "dl_ey")

# train_model: one epoch, a resume to the second, and two epochs at once.
modules = []
real_create = training.create_train_state
training.create_train_state = lambda *a, **k: modules.append(real_create(*a, **k)) or modules[-1]
kwargs = json.loads(str(data["train_kwargs"]))
folders = {}
for run, extra in (("part", {"epochs": 1}), ("whole", {"epochs": 2})):
    folders[run] = str(training.train_model(training.TrainingParams(
        results_location=f"{workdir}/{run}{rank}", device="cpu", **kwargs, **extra)))
    arrays.update({f"train_{run}/sd/{k}": v.numpy() for k, v in modules[-1].module.state_dict().items()})
with open(f"{workdir}/folders{rank}.json", "w") as fh:
    json.dump(folders, fh)
torch.distributed.barrier()
part0 = json.load(open(f"{workdir}/folders0.json"))["part"]
resume = dict(kwargs, model_architecture=None, epochs=2,
              resume_train_state=f"{part0}/train_state_latest.npz")
training.train_model(training.TrainingParams(
    results_location=f"{workdir}/resumed{rank}", device="cpu", **resume))
arrays.update({f"train_resumed/sd/{k}": v.numpy() for k, v in modules[-1].module.state_dict().items()})
state = training.load_train_state(f"{part0}/train_state_latest.npz")[0]
out["generator_states"] = [np.asarray(s).tolist() for s in state["generator_states"]]

np.savez(f"{workdir}/rank{rank}.npz", **arrays)
with open(f"{workdir}/rank{rank}.json", "w") as fh:
    json.dump(out, fh)
"""


def _cross_entropy64(labels, probs):
    """Cross-entropy in the probabilities' float64 (the registry's losses
    compute in float32, whose rounding a float64 comparison would read)."""
    onehot = torch.nn.functional.one_hot(labels[..., 0].long(), probs.shape[-1])
    return -(onehot * torch.log(probs)).sum(-1).mean()


def _port_unet(state_dict=None):
    module = get_model_class("unet")(**CONFIG).build_model(
        generator=torch.Generator().manual_seed(0), device="cpu"
    )
    if state_dict is not None:
        module.load_state_dict(state_dict)
    return module


def _one_device(module, loss, metric, batches, generator, ex, ey):
    """The port's one-device step on the whole batches."""
    state = tts.create_train_state(module, tts.build_optimizer("adam", {}))
    step = tts.make_train_step(module, loss, metric)
    got = []
    for x, y in batches:
        state, lv, mv = step(state, torch.from_numpy(x), torch.from_numpy(y), generator)
        got.append([float(lv), float(mv)])
    el, em = tts.make_eval_step(module, loss, metric)(state, torch.from_numpy(ex), torch.from_numpy(ey))
    grads = {k: p.grad for k, p in module.named_parameters()}
    return got, [float(el), float(em)], module.state_dict(), grads


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """The two ranks' results, JAX's spmd run and the port's one-device
    runs, on the same inputs."""
    workdir = tmp_path_factory.mktemp("spmd_step")
    init = _port_unet().state_dict()
    batches = [_batch(500 + i, GLOBAL_BATCH) for i in range(STEPS)]
    ex, ey = _batch(550, GLOBAL_BATCH)
    keys = [jax.random.PRNGKey(600 + i) for i in range(STEPS)]
    masks = np.stack([_jax_mask(k, (GLOBAL_BATCH,) + BOTTLENECK).numpy() for k in keys])
    dl_x, dl_y = dl._batch(700, GLOBAL_BATCH)
    dl_ex, dl_ey = dl._batch(750, GLOBAL_BATCH)
    ds = make_dataset(workdir / "ds.hdf5", n_train=8, n_val=4, n_test=2, h=H, w=W, seed=5)
    train_kwargs = dict(
        model_architecture="unet", training_dataset_path=str(ds), initial_model=None,
        opt_con="adam", opt_params={"learning_rate": LR}, loss="dice_loss_micro",
        metric="dice_coef_micro", batch_size=GLOBAL_BATCH,
        model_hyperparameters={"start_neurons": 2, "pool_layers": 2}, seed=SEED,
        augmentations=[
            {"name": "flip", "arguments": {"flip_type": "left-right"}},
            {"name": "add_noise", "arguments": {"mode": "gaussian", "variance": 0.01}},
        ],
        aug_mode="one", aug_fly=True, train_state_checkpoint=True,
        train_step_impl="spmd", train_forward_impl="s2d",
    )
    np.savez(
        workdir / "inputs.npz",
        config=json.dumps(CONFIG), dl_config=json.dumps(dl.CONFIG), seed=SEED,
        train_kwargs=json.dumps(train_kwargs),
        x=np.stack([b[0] for b in batches]), y=np.stack([b[1] for b in batches]),
        masks=masks, ex=ex, ey=ey, dl_x=dl_x, dl_y=dl_y, dl_ex=dl_ex, dl_ey=dl_ey,
        **{"sd/" + k: v.numpy() for k, v in init.items()},
    )
    procs = start_ranks(workdir, RANK_BODY, world=2, local=2)

    # JAX: the spmd step on a 2-device mesh, the batch sharded over it.
    jmod = jax_model_class("unet")(**CONFIG).build_model()
    variables = flax_from_state_dict(init)
    _, jloss, _ = _loss_pair("focal_dice_loss")
    jmetric = jm.dice_coef_macro(True, C)
    mesh = jax_mesh(jax.devices()[:2])
    tx = jts.build_optimizer("adam", {})
    state = jts.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx, mesh)
    step = jts.make_train_step(jmod, tx, jloss, jmetric, mesh, impl="spmd")
    evaluate = jts.make_eval_step(jmod, jloss, jmetric, mesh, impl="spmd")
    want = {"jax": {"steps": []}}
    for (x, y), key in zip(batches, keys):
        xs, ys = shard_batch((x, y), mesh)
        state, lv, mv = step(state, xs, ys, key)
        want["jax"]["steps"].append([float(lv), float(mv)])
    want["jax"]["eval"] = [float(v) for v in evaluate(state, *shard_batch((ex, ey), mesh))]
    want["jax"]["sd"] = _state_dict_of(state.params, state.batch_stats)

    # The port's one-device step on the global batch.
    micro = tl.dice_loss_micro(num_classes=C, is_y_true_sparse=True)
    micro_metric = tm.dice_coef_micro(True, C)
    gen = torch.Generator().manual_seed(SEED)
    got, ev, sd, grads = _one_device(_port_unet(init), micro, micro_metric, batches, gen, ex, ey)
    want["one"] = {"steps": got, "eval": ev, "sd": sd}
    got, ev, sd, grads = _one_device(
        S2DTrainForward(_port_unet(init)), micro, micro_metric, batches[:1],
        torch.Generator().manual_seed(SEED), ex, ey,
    )
    want["s2d"] = {"steps": got, "eval": ev, "sd": sd}
    dl_module = get_model_class("deeplabv3plus")(**dl.CONFIG).build_model(
        generator=torch.Generator().manual_seed(3), device="cpu"
    ).double()
    got, ev, sd, grads = _one_device(
        dl_module, _cross_entropy64, _cross_entropy64,
        [(dl_x, dl_y)], torch.Generator().manual_seed(SEED), dl_ex, dl_ey,
    )
    want["deeplab"] = {"steps": got, "eval": ev, "sd": sd, "grads": grads}
    join_ranks(procs)
    ranks = [
        (json.loads((workdir / f"rank{r}.json").read_text()), np.load(workdir / f"rank{r}.npz"))
        for r in range(2)
    ]
    return ranks, want


def _sd(npz, name, part="sd"):
    prefix = f"{name}/{part}/"
    return {k[len(prefix):]: torch.from_numpy(npz[k]) for k in npz.files if k.startswith(prefix)}


def test_ranks_end_bit_equal(spmd):
    (out0, npz0), (out1, npz1) = spmd[0]
    assert out0 == out1
    assert sorted(npz0.files) == sorted(npz1.files)
    for k in npz0.files:
        assert np.array_equal(npz0[k], npz1[k]), f"ranks differ in {k}"
    assert any("/opt/" in k for k in npz0.files)


def test_spmd_steps_match_jax_spmd_mesh(spmd):
    (out, npz), _ = spmd[0]
    want = spmd[1]["jax"]
    for (gl, gm), (wl, wm) in zip(out["jax"]["steps"], want["steps"]):
        assert abs(gl - wl) <= RTOL * abs(wl) and abs(gm - wm) <= RTOL * abs(wm), (gl, wl, gm, wm)
    _check_params(_sd(npz, "jax"), want["sd"], STEPS, LR)
    for got, w in zip(out["jax"]["eval"], want["eval"]):
        assert abs(got - w) <= EVAL_RTOL * abs(w) + 1e-6, (out["jax"]["eval"], want["eval"])


def _check_float64(got, want, npz):
    """Gradients per tensor within F64_TOL of the tensor's max (the pre-BN
    conv biases, whose exact gradient is 0, of the largest gradient's),
    statistics within F64_TOL."""
    largest = max(float(g.abs().max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        err = float((_sd(npz, "deeplab", "grad")[k] - g).abs().max())
        pre_bn = k.endswith("conv.bias") and k.replace("conv.bias", "bn.weight") in want["sd"]
        scale = largest if pre_bn else float(g.abs().max())
        assert err <= F64_TOL * scale, (k, err, scale)
    for k, v in want["sd"].items():
        if "running" in k:
            err = float((got[k] - v).abs().max())
            assert err <= F64_TOL * max(float(v.abs().max()), 1.0), (k, err)


@pytest.mark.parametrize("name", ["one", "s2d"])
def test_spmd_is_the_one_device_step_on_the_global_batch(spmd, name):
    (out, npz), _ = spmd[0]
    want = spmd[1][name]
    assert len(out[name]["steps"]) == len(want["steps"])
    for got, w in zip(out[name]["steps"], want["steps"]):
        for g, v in zip(got, w):
            assert abs(g - v) <= ONE_RTOL * abs(v), (name, got, w)
    # The eval reads the parameters after Adam, which normalises the
    # gradients' rounding noise (see _check_params).
    for g, v in zip(out[name]["eval"], want["eval"]):
        assert abs(g - v) <= RTOL * abs(v) + 1e-7, (name, out[name]["eval"], want["eval"])
    _check_params(_sd(npz, name), want["sd"], len(want["steps"]), LR)


def test_spmd_deeplab_float64_step(spmd):
    (out, npz), _ = spmd[0]
    want = spmd[1]["deeplab"]
    for got, w in zip(out["deeplab"]["steps"] + [out["deeplab"]["eval"]], want["steps"] + [want["eval"]]):
        for g, v in zip(got, w):
            assert abs(g - v) <= F64_TOL * abs(v), (got, w)
    _check_float64(_sd(npz, "deeplab"), want, npz)


def test_train_model_spmd_resumes_exactly(spmd):
    (out, npz), _ = spmd[0]
    states = out["generator_states"]
    assert len(states) == 2 and states[0] == states[1]  # one stream on every rank
    whole, resumed = _sd(npz, "train_whole"), _sd(npz, "train_resumed")
    assert whole and set(whole) == set(resumed)
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k
    assert not all(torch.equal(whole[k], v) for k, v in _sd(npz, "train_part").items())


def test_global_batch_switch():
    """Outside an spmd step the switch is off and the draws are the local
    ones; inside, a draw is the global batch's and this rank keeps its
    rows; the switch is this thread's alone."""
    import threading

    from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib

    assert mesh_lib.global_mesh() is None
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh_lib.sum_over_global_batch(t) is t
    assert mesh_lib.global_batch_size(3) == 3
    draws = mesh_lib.draw_rows(lambda shape: torch.zeros(shape), (3, 2))
    assert draws.shape == (3, 2)
    stub = mesh_lib.Mesh(1, 2, 1, torch.device("cpu"))
    with mesh_lib.global_batch(stub):
        assert mesh_lib.global_mesh() is stub and mesh_lib.global_batch_size(3) == 6
        gen = torch.Generator().manual_seed(0)
        rows = mesh_lib.draw_rows(lambda shape: torch.rand(shape, generator=gen), (3, 2))
        full = torch.rand((6, 2), generator=torch.Generator().manual_seed(0))
        assert torch.equal(rows, full[3:])
        seen = []
        thread = threading.Thread(target=lambda: seen.append(mesh_lib.global_mesh()))
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive() and seen == [None]
    assert mesh_lib.global_mesh() is None
