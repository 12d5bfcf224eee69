"""The port's data-parallel train and eval steps and its cross-rank
precise-BN refresher against the JAX package's mesh, on the CPU.

The ranks are processes in a gloo process group (a file store in the
test's directory, a 60 s collective timeout, one thread each), spawned as
``tests/test_multihost.py`` spawns JAX processes and joined with a
timeout. Weights are JAX-initialised and bridged (``state_dict_from_flax``),
at the U-Net and sizes of ``tests/test_torch_train_step.py`` (32x48, 3
classes, start_neurons=2, pool_layers=2).

- Two ranks on one node against JAX ``make_train_step(impl="shard_map")``
  on a 2-device virtual CPU mesh, 3 Adam steps of a global batch of 4,
  each rank's dropout mask replaced by JAX's mask for
  ``fold_in(key, rank)`` (``ops/s2d_train.py::_DropoutShim``): loss and
  metric per step rel 1e-5, parameters and BN statistics as
  ``test_torch_train_step._check_params`` holds them (atol 1e-5; the
  pre-BN conv biases, whose exact gradient is 0, within 2 * steps * lr),
  the eval step rel 1e-4, and both ranks' states bit for bit equal.
- JAX's shard_map step applies the SUM of the devices' gradients, not
  their mean: the transpose of shard_map's implicit broadcast of the
  replicated parameters already sums the gradients over the axis, and the
  ``pmean`` that follows leaves the sum as it is. The port averages
  (DDP; the MirroredStrategy semantics JAX's docstring names), so JAX's
  gradients of one step (an SGD step at learning rate 1) must be twice
  the port's, within 5e-4 of each tensor's max (the one-device test's
  bound). Adam is scale-free but for its epsilon: JAX's Adam with twice
  the port's epsilon makes the same update, and that is what the 3-step
  trajectory is held against.
- The cross-rank ``BNRefresher`` (dropout off) against JAX's
  ``BNRefresher`` on both ranks' batches in one process: atol 1e-6, rtol
  1e-5. Unequal batch counts raise on every rank.
- ``impl="spmd"`` on the same two ranks: one step on the global batch
  (JAX's global dropout mask, each rank its rows) against JAX's spmd step
  on the 2-device mesh, loss rel 1e-5 (``tests/test_torch_spmd_step.py``
  holds the rest of it).
- One ``impl="shard_map"`` step over the s2d training forward
  (``S2DTrainForward``, whose parameters are the parity module's, in
  order) on the same two ranks, each with its JAX mask: the gradients
  DDP averages within 1e-4 of each tensor's max (the pre-BN conv
  biases, whose exact gradient is 0, of the largest gradient's) of the
  mean of the one-device s2d steps on each rank's rows and mask, and twice them
  within 5e-4 of JAX's shard_map step over its s2d forward (JAX sums).
- A world of one against the one-device step: bit for bit.
- Two nodes of two ranks, each rank on its own data: every rank's weights
  and statistics bit for bit equal after 4 steps.
"""

import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import bn_refresh as jax_bn
from oct_image_segmentation_models_tpu.ops import metrics as jm
from oct_image_segmentation_models_tpu.ops import s2d_train as jst
from oct_image_segmentation_models_tpu.parallel import train_step as jts
from oct_image_segmentation_models_tpu.parallel.mesh import create_mesh as jax_mesh
from oct_image_segmentation_models_torch.ops import losses as tl
from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
from oct_image_segmentation_models_torch.models import unet as port_unet
from oct_image_segmentation_models_torch.ops import metrics as tm
from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward
from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib
from oct_image_segmentation_models_torch.parallel import train_step as tts

from test_torch_train_step import (
    CONFIG,
    C,
    H,
    RTOL,
    STAT_ATOL,
    W,
    _batch,
    _check_grad,
    _check_params,
    _jax_mask,
    _loss_pair,
    _port_module,
    _port_module_random,
    _pre_bn_bias,
    _state_dict_of,
)
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

REPO = Path(__file__).resolve().parents[1]
STEPS = 3
GLOBAL_BATCH = 4
EVAL_RTOL = 1e-4
ADAM_EPS = 1e-7  # the Keras default both packages build "adam" with
RANK_TIMEOUT_S = 120
# DDP over the s2d forward against the mean of the one-device s2d steps:
# the same float32 gradients, from ranks of one thread and this process's
# threads, averaged by gloo's all-reduce and here (measured at most 1.04e-5
# of a tensor's max, in a BatchNorm scale whose gradient nearly cancels).
S2D_REPLICA_RTOL = 1e-4
# The bottleneck's NCHW shape at start_neurons=2, pool_layers=2: where the
# dropout mask is drawn.
BOTTLENECK = (CONFIG["start_neurons"] * 4, H // 4, W // 4)

# Runs in each rank: joins the process group, builds the rank's mesh, then
# runs the test's body with ``mesh`` and ``workdir`` defined.
PREAMBLE = """
import json, sys
from datetime import timedelta
import numpy as np
import torch

torch.set_num_threads(1)
from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib

store, rank, world, local, workdir = sys.argv[1:6]
rank, world, local = int(rank), int(world), int(local)
mesh_lib.init_distributed(
    "cpu", rank=rank, world_size=world, init_method=store, timeout=timedelta(seconds=60)
)
mesh = mesh_lib.create_mesh(local_size=local, device="cpu")
"""


def start_ranks(workdir: Path, body: str, world: int, local: int) -> list:
    """Start ``PREAMBLE + body`` in ``world`` processes of ``local`` ranks
    per node."""
    script = workdir / "rank.py"
    script.write_text(PREAMBLE + body)
    store = f"file://{workdir / 'store'}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    return [
        subprocess.Popen(
            [sys.executable, str(script), store, str(rank), str(world), str(local), str(workdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]


def join_ranks(procs: list) -> list:
    """The ranks' outputs. A rank that fails or outlives ``RANK_TIMEOUT_S``
    fails the test."""
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outputs


def run_ranks(workdir: Path, body: str, world: int, local: int) -> list:
    return join_ranks(start_ranks(workdir, body, world, local))


TWO_RANK_BODY = """
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models import unet
from oct_image_segmentation_models_torch.ops import losses, metrics
from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
from oct_image_segmentation_models_torch.parallel import train_step as ts

data = np.load(f"{workdir}/inputs.npz")
config = json.loads(str(data["config"]))
rows = mesh.local_rows(int(data["x"].shape[1]))
masks = [torch.from_numpy(m) for m in data["masks"][:, rank]]
unet.dropout_mask = lambda x, generator: masks.pop(0)


def module_from_inputs():
    module = get_model_class("unet")(**config).build_model(device="cpu")
    module.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")})
    return module


module = module_from_inputs()
loss_fn = losses.custom_loss_objects["focal_dice_loss"]["function"](num_classes=3, is_y_true_sparse=True)
metric_fn = metrics.dice_coef_macro(True, 3)
# One spmd step on a copy: the global batch's loss on every rank.
spmd_module = module_from_inputs()
spmd_state = ts.create_train_state(spmd_module, ts.build_optimizer("adam", {}), mesh)
spmd_step = ts.make_train_step(spmd_module, loss_fn, metric_fn, mesh, impl="spmd")
masks.insert(0, torch.from_numpy(data["spmd_mask"][rows]))
_, spmd_loss, _ = spmd_step(
    spmd_state, torch.from_numpy(data["x"][0][rows]), torch.from_numpy(data["y"][0][rows]), None
)
state = ts.create_train_state(module, ts.build_optimizer("adam", {}), mesh)
step = ts.make_train_step(module, loss_fn, metric_fn, mesh, impl="shard_map")
evaluate = ts.make_eval_step(module, loss_fn, metric_fn, mesh)  # "auto": per replica
out = {"loss": [], "metric": []}
for x, y in zip(data["x"], data["y"]):
    state, loss, metric = step(state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), None)
    out["loss"].append(float(loss))
    out["metric"].append(float(metric))
    if len(out["loss"]) == 1:  # the gradients of the first step, averaged by DDP
        grads = {"grad/" + k: p.grad.numpy().copy() for k, p in module.named_parameters()}
assert not masks and state.step == len(data["x"])
el, em = evaluate(state, torch.from_numpy(data["ex"][rows]), torch.from_numpy(data["ey"][rows]))
out["eval"] = [float(el), float(em)]
out["spmd_loss"] = float(spmd_loss)

batches = [torch.from_numpy(b) for b in data["stat_x"][rank]]
refresher = BNRefresher(module_from_inputs(), deterministic=True)
stats = refresher(None, batches, cross_process=True)
try:
    refresher(None, batches[: 2 - rank], cross_process=True)
    out["unequal"] = "no error"
except ValueError as exc:
    out["unequal"] = str(exc)

# One shard_map step over the s2d training forward: DDP over
# S2DTrainForward, whose parameters are the parity module's, in order.
from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward

s2d_module = module_from_inputs()
s2d_forward = S2DTrainForward(s2d_module)
assert [id(p) for p in s2d_forward.parameters()] == [id(p) for p in s2d_module.parameters()]
s2d_state = ts.create_train_state(s2d_forward, ts.build_optimizer("sgd", {"learning_rate": 1.0}), mesh)
s2d_step = ts.make_train_step(s2d_forward, loss_fn, metric_fn, mesh, impl="shard_map")
masks.append(torch.from_numpy(data["masks"][0, rank]))
s2d_step(s2d_state, torch.from_numpy(data["x"][0][rows]), torch.from_numpy(data["y"][0][rows]), None)
assert not masks and all(p.grad is not None for p in s2d_module.parameters())
grads.update({"s2dgrad/" + k: p.grad.numpy().copy() for k, p in s2d_module.named_parameters()})
np.savez(
    f"{workdir}/rank{rank}.npz",
    **{"sd/" + k: v.numpy() for k, v in module.state_dict().items()},
    **{"stat/" + k: v.numpy() for k, v in stats.items()},
    **grads,
)
with open(f"{workdir}/rank{rank}.json", "w") as fh:
    json.dump(out, fh)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two ranks' results and JAX's on the same inputs."""
    workdir = tmp_path_factory.mktemp("dp_step")
    jmod = jax_model_class("unet")(**CONFIG).build_model()
    variables = jax.jit(
        lambda k: jmod.init(k, jnp.zeros((1, H, W, 1)), training=False)
    )(jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    batches = [_batch(200 + i, GLOBAL_BATCH) for i in range(STEPS)]
    keys = [jax.random.PRNGKey(300 + i) for i in range(STEPS)]
    per_rank = GLOBAL_BATCH // 2
    masks = np.stack([
        np.stack([
            _jax_mask(jax.random.fold_in(key, d), (per_rank,) + BOTTLENECK).numpy()
            for d in range(2)
        ])
        for key in keys
    ])
    # The spmd step's global mask, drawn for the whole batch.
    spmd_mask = _jax_mask(keys[0], (GLOBAL_BATCH,) + BOTTLENECK).numpy()
    ex, ey = _batch(250, GLOBAL_BATCH)
    stat_x = np.stack([np.stack([_batch(260 + 2 * r + i)[0] for i in range(2)]) for r in range(2)])
    sd = _port_module(variables).state_dict()
    np.savez(
        workdir / "inputs.npz",
        config=json.dumps(CONFIG),
        x=np.stack([b[0] for b in batches]), y=np.stack([b[1] for b in batches]),
        masks=masks, spmd_mask=spmd_mask, ex=ex, ey=ey, stat_x=stat_x,
        **{"sd/" + k: v.numpy() for k, v in sd.items()},
    )
    run_ranks(workdir, TWO_RANK_BODY, world=2, local=2)
    ranks = [
        (json.loads((workdir / f"rank{r}.json").read_text()), np.load(workdir / f"rank{r}.npz"))
        for r in range(2)
    ]

    # JAX: the shard_map step on a 2-device mesh from the same weights. Its
    # gradients are the sum over the devices: one SGD step at learning
    # rate 1 gives them; Adam with twice the epsilon is the port's Adam on
    # their mean.
    _, jloss, _ = _loss_pair("focal_dice_loss")
    jmetric = jm.dice_coef_macro(True, C)
    mesh = jax_mesh(jax.devices()[:2])
    def params():  # fresh device arrays: the steps donate their state
        return jax.tree_util.tree_map(jnp.asarray, variables)

    sgd = jts.build_optimizer("sgd", {"learning_rate": 1.0})
    sgd_step = jts.make_train_step(jmod, sgd, jloss, jmetric, mesh, impl="shard_map")
    after, _, _ = sgd_step(
        jts.create_train_state(params(), sgd, mesh), jnp.asarray(batches[0][0]),
        jnp.asarray(batches[0][1]), keys[0],
    )
    before = _state_dict_of(variables["params"], variables["batch_stats"])
    after = _state_dict_of(after.params, after.batch_stats)
    want = {"grad_sum": {k: before[k] - after[k] for k in before if "running" not in k}}
    # The same step over JAX's s2d training forward, and the port's
    # per-replica definition over its own: the one-device step on each
    # rank's rows with that rank's mask, then the mean.
    after, _, _ = jts.make_train_step(
        jst.S2DTrainForward(CONFIG), sgd, jloss, jmetric, mesh, impl="shard_map"
    )(jts.create_train_state(params(), sgd, mesh), jnp.asarray(batches[0][0]),
      jnp.asarray(batches[0][1]), keys[0])
    after = _state_dict_of(after.params, after.batch_stats)
    want["s2d_grad_sum"] = {k: before[k] - after[k] for k in before if "running" not in k}
    tloss = _loss_pair("focal_dice_loss")[2]
    replicas = []
    saved_mask = port_unet.dropout_mask
    try:
        for r in range(2):
            port_unet.dropout_mask = lambda x, generator, r=r: torch.from_numpy(masks[0, r])
            module = _port_module(variables)
            forward = S2DTrainForward(module)
            step = tts.make_train_step(forward, tloss, tm.dice_coef_macro(True, C))
            rows = slice(r * per_rank, (r + 1) * per_rank)
            step(
                tts.create_train_state(forward, tts.build_optimizer("sgd", {"learning_rate": 1.0})),
                torch.from_numpy(batches[0][0][rows]), torch.from_numpy(batches[0][1][rows]), None,
            )
            replicas.append({k: p.grad for k, p in module.named_parameters()})
    finally:
        port_unet.dropout_mask = saved_mask
    want["s2d_replica_mean"] = {k: (replicas[0][k] + replicas[1][k]) / 2 for k in replicas[0]}
    tx = jts.build_optimizer("adam", {"epsilon": 2 * ADAM_EPS})
    state = jts.create_train_state(params(), tx, mesh)
    step = jts.make_train_step(jmod, tx, jloss, jmetric, mesh, impl="shard_map")
    evaluate = jts.make_eval_step(jmod, jloss, jmetric, mesh, impl="shard_map")
    want.update(loss=[], metric=[])
    for (x, y), key in zip(batches, keys):
        state, lv, mv = step(state, jnp.asarray(x), jnp.asarray(y), key)
        want["loss"].append(float(lv))
        want["metric"].append(float(mv))
    want["eval"] = [float(v) for v in evaluate(state, jnp.asarray(ex), jnp.asarray(ey))]
    want["sd"] = _state_dict_of(state.params, state.batch_stats)
    spmd_step = jts.make_train_step(jmod, tx, jloss, jmetric, mesh, impl="spmd")
    _, want["spmd_loss"], _ = spmd_step(
        jts.create_train_state(params(), tx, mesh), jnp.asarray(batches[0][0]),
        jnp.asarray(batches[0][1]), keys[0],
    )
    precise = jax_bn.compute_precise_batch_stats(
        jmod, variables["params"], variables["batch_stats"],
        [jnp.asarray(b) for b in stat_x.reshape((-1,) + stat_x.shape[2:])],
        jax.random.PRNGKey(0), deterministic=True,
    )
    want["stats"] = _state_dict_of(variables["params"], precise)
    return ranks, want


def test_two_rank_step_matches_jax_shard_map(two_ranks):
    ranks, want = two_ranks
    (out0, npz0), (out1, npz1) = ranks
    assert out0 == out1  # the world's mean loss and metric on every rank
    for k in npz0.files:
        assert np.array_equal(npz0[k], npz1[k]), f"ranks differ in {k}"
    for got, wl in zip(out0["loss"], want["loss"]):
        assert abs(got - wl) <= RTOL * abs(wl), (got, wl)
    for got, wm in zip(out0["metric"], want["metric"]):
        assert abs(got - wm) <= RTOL * abs(wm), (got, wm)
    got_sd = {k[3:]: torch.from_numpy(npz0[k]) for k in npz0.files if k.startswith("sd/")}
    _check_params(got_sd, want["sd"], STEPS, 1e-3)
    for got, w in zip(out0["eval"], want["eval"]):
        assert abs(got - w) <= EVAL_RTOL * abs(w) + 1e-6, (out0["eval"], want["eval"])
    # "spmd" on the same two ranks steps on the global batch, as JAX's.
    wl = float(want["spmd_loss"])
    assert abs(out0["spmd_loss"] - wl) <= RTOL * abs(wl), (out0["spmd_loss"], wl)


def test_jax_shard_map_sums_what_the_port_averages(two_ranks):
    ranks, want = two_ranks
    npz = ranks[0][1]
    for k, g_sum in want["grad_sum"].items():
        got = 2 * torch.from_numpy(npz["grad/" + k])
        if _pre_bn_bias(k):  # exact gradient 0: float noise on both sides
            continue
        _check_grad(got, g_sum, k)


def test_ddp_over_s2d_forward_is_the_per_replica_step(two_ranks):
    """DDP over ``S2DTrainForward`` averages the ranks' s2d gradients: the
    mean of the one-device s2d steps on each rank's rows and mask."""
    ranks, want = two_ranks
    (_, npz0), (_, npz1) = ranks
    largest = max(float(g.abs().max()) for g in want["s2d_replica_mean"].values())
    for k, g in want["s2d_replica_mean"].items():
        got = npz0["s2dgrad/" + k]
        assert np.array_equal(got, npz1["s2dgrad/" + k]), f"ranks differ in {k}"
        # a pre-BN conv bias's exact gradient is 0: noise, held against
        # the largest gradient
        scale = largest if _pre_bn_bias(k) else float(g.abs().max())
        err = float((torch.from_numpy(got) - g).abs().max())
        assert err <= S2D_REPLICA_RTOL * scale, (k, err)


def test_jax_shard_map_over_s2d_sums_what_the_port_averages(two_ranks):
    ranks, want = two_ranks
    npz = ranks[0][1]
    for k, g_sum in want["s2d_grad_sum"].items():
        if _pre_bn_bias(k):  # exact gradient 0: float noise on both sides
            continue
        _check_grad(2 * torch.from_numpy(npz["s2dgrad/" + k]), g_sum, k)


def test_cross_rank_refresher_matches_jax_on_all_batches(two_ranks):
    ranks, want = two_ranks
    (out0, npz0), (out1, _) = ranks
    got = {k[5:]: npz0[k] for k in npz0.files if k.startswith("stat/")}
    assert set(got) == {k for k in want["stats"] if "running" in k}
    for k, v in got.items():
        np.testing.assert_allclose(v, want["stats"][k].numpy(), atol=STAT_ATOL, rtol=1e-5, err_msg=k)
    for out in (out0, out1):
        assert "2 batches" in out["unequal"] and "1 to" in out["unequal"], out["unequal"]


def test_world_of_one_is_the_one_device_step(tmp_path):
    """shard_map (DDP over a gloo world of one) against the one-device
    step: the same weights, batches and dropout generator, 3 steps, bit for
    bit; the cross-rank refresher at one rank is the one-process one."""
    loss_fn = tl.focal_dice_loss(num_classes=C)
    metric_fn = tm.dice_coef_macro(True, C)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
        timeout=timedelta(seconds=60),
    )
    try:
        mesh = mesh_lib.create_mesh(device="cpu")
        assert (mesh.world, mesh.nodes, mesh.local_size, mesh.rank) == (1, 1, 1, 0)
        runs = []
        for use_mesh in (True, False):
            module = _port_module_random()
            state = tts.create_train_state(module, tts.build_optimizer("adam", {}), mesh if use_mesh else None)
            kwargs = dict(mesh=mesh, impl="shard_map") if use_mesh else {}
            step = tts.make_train_step(module, loss_fn, metric_fn, **kwargs)
            evaluate = tts.make_eval_step(module, loss_fn, metric_fn, **kwargs)
            gen = torch.Generator().manual_seed(5)
            losses = []
            for i in range(STEPS):
                x, y = (torch.from_numpy(a) for a in _batch(400 + i))
                state, loss, metric = step(state, x, y, gen)
                losses.append((loss, metric))
            losses.append(evaluate(state, *(torch.from_numpy(a) for a in _batch(450))))
            stats = BNRefresher(module, deterministic=True)(
                None, [torch.from_numpy(_batch(460)[0])], cross_process=use_mesh
            )
            runs.append((module.state_dict(), losses, stats))
        (sd_a, l_a, s_a), (sd_b, l_b, s_b) = runs
        for k in sd_b:
            assert torch.equal(sd_a[k], sd_b[k]), k
        for (la, ma), (lb, mb) in zip(l_a, l_b):
            assert torch.equal(la, lb) and torch.equal(ma, mb)
        for k in s_b:
            assert torch.equal(s_a[k], s_b[k]), k
    finally:
        dist.destroy_process_group()


def test_create_mesh_arguments(tmp_path, monkeypatch):
    """create_mesh needs a process group and ranks per node that divide
    the world; a bare "cuda" is the local rank's card; the layout and its
    groups are built once per process group."""
    with pytest.raises(ValueError, match="initialised process group"):
        mesh_lib.create_mesh(device="cpu")
    # The rule alone: resolve_device, which checks that the card is there,
    # passes the device through.
    monkeypatch.setattr(mesh_lib, "resolve_device", lambda d: d)
    assert mesh_lib.rank_device(None, 3, 2) == torch.device("cuda", 1)
    assert mesh_lib.rank_device("cuda", 3, 2) == torch.device("cuda", 1)
    assert mesh_lib.rank_device("cuda:0", 3, 2) == torch.device("cuda", 0)
    assert mesh_lib.rank_device("cpu", 3, 2) == torch.device("cpu")
    monkeypatch.undo()
    builds = []
    from torch.distributed import device_mesh

    real = device_mesh.init_device_mesh

    def counted(*args, **kwargs):
        builds.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(device_mesh, "init_device_mesh", counted)
    for attempt in range(2):  # the second process group gets its own layout
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path / f'store{attempt}'}", rank=0,
            world_size=1, timeout=timedelta(seconds=60),
        )
        try:
            with pytest.raises(ValueError, match="2 ranks per node do not divide a world of 1"):
                mesh_lib.create_mesh(local_size=2, device="cpu")
            a = mesh_lib.create_mesh(device="cpu")
            b = mesh_lib.create_mesh(local_size=1, device="cpu")
            assert a == b and a.host_group is dist.group.WORLD
            assert (a.world, a.node, a.local_rank, a.device) == (1, 0, 0, torch.device("cpu"))
            assert builds == [("cpu", (1, 1))] * (attempt + 1)
        finally:
            dist.destroy_process_group()


WEIGHT_SYNC_BODY = """
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops import losses, metrics
from oct_image_segmentation_models_torch.parallel import train_step as ts

config = dict(input_channels=1, num_classes=3, image_height=16, image_width=16,
              start_neurons=2, pool_layers=2)
# Every rank starts from its own random weights: create_train_state must
# give them rank 0's.
module = get_model_class("unet")(**config).build_model(
    generator=torch.Generator().manual_seed(rank), device="cpu"
)
state = ts.create_train_state(module, ts.build_optimizer("adam", {}), mesh)
loss_fn = losses.custom_loss_objects["dice_loss_macro"]["function"](num_classes=3, is_y_true_sparse=True)
step = ts.make_train_step(module, loss_fn, metrics.dice_coef_macro(True, 3), mesh)
# Distinct data and dropout on every rank: equal weights afterwards hold
# only if the gradients and statistics are averaged every step.
rng = np.random.default_rng(100 + rank)
gen = torch.Generator().manual_seed(rank)
for _ in range(4):
    x = torch.from_numpy(rng.random((2, 16, 16, 1), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (2, 16, 16, 1)).astype(np.int32))
    state, loss, metric = step(state, x, y, gen)
flat = np.concatenate([v.numpy().ravel() for v in module.state_dict().values()])
np.save(f"{workdir}/weights{rank}.npy", flat)
with open(f"{workdir}/coords{rank}.json", "w") as fh:
    rows = mesh.local_rows(4)
    json.dump([mesh.node, mesh.local_rank, mesh.nodes, mesh.local_size, rows.start, rows.stop], fh)
"""


def test_two_nodes_of_two_ranks_stay_in_sync(tmp_path):
    run_ranks(tmp_path, WEIGHT_SYNC_BODY, world=4, local=2)
    weights = [np.load(tmp_path / f"weights{r}.npy") for r in range(4)]
    assert np.isfinite(weights[0]).all()
    for r in range(1, 4):
        assert np.array_equal(weights[0], weights[r]), (
            f"rank {r} desynced: max |delta| {np.abs(weights[0] - weights[r]).max()}"
        )
    coords = [json.loads((tmp_path / f"coords{r}.json").read_text()) for r in range(4)]
    assert coords == [[r // 2, r % 2, 2, 2, 2 * (r % 2), 2 * (r % 2) + 2] for r in range(4)]
