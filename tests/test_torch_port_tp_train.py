"""The port's tensor-parallel train step against the JAX package's sharded
step.

``make_train_step`` on a state placed by ``shard_train_state`` (conv output
channels over 'model', the batch over 'data') runs in spawned gloo ranks on
the CPU, world 2 and world 4, one module-scoped spawn per world with its
own timeout.  Each rank passes its 'data' block of one global batch.  On
meshes (1, 2) and (2, 2), three fp64 steps with AdamW (3e-4) and SGD
(1e-3) are held against the JAX package's jitted ``make_train_step`` over
the same ``NamedSharding``s on the test process's virtual CPU devices, from
the same Flax weights: losses within 1e-9 relative, parameters within
1e-12 absolute (the bounds of ``test_train_steps_match_jax``).  Meshes
(2, 1) and (4, 1), dropout and Adafactor are held against the port's
single-process step; the rest checks the local convolutions, the mirror
of ``__graft_entry__.dryrun_multichip``'s train step and the errors.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from torch_asg_tpu.models import Wav2Letter as FlaxWav2Letter
from torch_asg_tpu.models import make_train_step as jax_make_train_step
from torch_asg_tpu.models.train import TrainState as JaxTrainState
from torch_asg_tpu.models.train import shard_train_state as jax_shard_train_state
from torch_asg_tpu.parallel import make_mesh as jax_make_mesh
from torch_asg_tpu_torch.convert import wav2letter_from_flax
from torch_asg_tpu_torch.models import (Wav2Letter, create_train_state, make_train_step,
                                        shard_train_state)
from torch_asg_tpu_torch.parallel.launch import spawn_ranks

FEAT = 16
CFG = dict(num_labels=8, channels=16, depth=1, head_channels=16)
STEPS = 3
SPAWN_TIMEOUT_S = 300
# per world: the meshes held against the JAX package, then against the
# port's single-process step (no 'model' split)
JAX_MESH = {2: (1, 2), 4: (2, 2)}
DATA_MESH = {2: (2, 1), 4: (4, 1)}


def adafactor(params):
    return torch.optim.Adafactor(params, lr=1e-2)


OPTIMIZERS = {
    "adamw": (lambda: optax.adamw(3e-4), None),
    "sgd": (lambda: optax.sgd(1e-3), lambda p: torch.optim.SGD(p, lr=1e-3)),
}


def _batch():
    rng = np.random.default_rng(12)
    return {
        "features": rng.normal(size=(4, 14, FEAT)),
        "feature_lengths": np.array([14, 11, 8, 13], np.int32),
        "targets": rng.integers(0, CFG["num_labels"], size=(4, 4)).astype(np.int32),
        "target_lengths": np.array([4, 2, 3, 1], np.int32),
    }


def _flax_params(key=0):
    model = FlaxWav2Letter(**CFG)
    params = model.init(jax.random.key(key), jnp.zeros((1, 16, FEAT), jnp.float64))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                  flax.core.meta.unbox(params["params"]))


def _port_model(params, **kw):
    model = Wav2Letter(in_features=FEAT, device="cpu", dtype=torch.float64, **{**CFG, **kw})
    model.load_state_dict(wav2letter_from_flax(params))
    return model


def _block(batch, mesh):
    """This rank's 'data' block of a global batch, as tensors."""
    d, size = mesh.get_local_rank("data"), mesh.size(0)
    per = len(batch["features"]) // size
    return {k: torch.from_numpy(v[d * per:(d + 1) * per]) for k, v in batch.items()}


def _steps(model, make, mesh, batch, steps=STEPS, **step_kw):
    """``steps`` tensor-parallel steps from a fresh state: (losses, every
    parameter's full tensor, its placements)."""
    state = shard_train_state(mesh, model, create_train_state(model, make))
    step = make_train_step(model, state.optimizer, **step_kw)
    block = _block(batch, mesh)
    losses = [float(step(state, block)[1]) for _ in range(steps)]
    named = [*model.named_parameters(), ("transition", state.transition)]
    return {"losses": losses,
            "params": {n: p.detach().full_tensor().numpy() for n, p in named},
            "placements": {n: tuple(p.placements) for n, p in named}}


def _conv_calls(model, mesh, batch):
    """The weight shape of every convolution that one forward ran, and the
    namespaces of the collectives it called."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.convs, self.namespaces = [], set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                self.convs.append((type(args[1]).__name__, tuple(args[1].shape)))
            if func.namespace in ("c10d", "_c10d_functional"):
                self.namespaces.add(func.namespace)
            return func(*args, **(kwargs or {}))

    shard_train_state(mesh, model, create_train_state(model))
    with Record() as rec:
        model(_block(batch, mesh)["features"])
    return {"convs": rec.convs, "namespaces": sorted(rec.namespaces)}


def _dryrun_mirror(world):
    """``dryrun_multichip(world)``'s train step at its own shapes: N=16,
    F=32, channels 64, depth 1, head 64, SGD 1e-3, B = 2 D, T=16, S=4,
    float32, impl='scan', on its (world/2, 2) mesh."""
    from torch_asg_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world // 2, 2), ("data", "model"), device="cpu")
    torch.manual_seed(0)
    model = Wav2Letter(num_labels=16, in_features=32, channels=64, depth=1,
                       head_channels=64, device="cpu")
    r = np.random.default_rng(0)
    b = 2 * (world // 2)
    batch = {"features": r.normal(size=(b, 16, 32)).astype(np.float32),
             "feature_lengths": np.full((b,), 16, np.int32),
             "targets": r.integers(0, 16, size=(b, 4)).astype(np.int32),
             "target_lengths": np.full((b,), 4, np.int32)}
    return _steps(model, lambda p: torch.optim.SGD(p, lr=1e-3), mesh, batch, steps=1,
                  impl="scan")["losses"][0]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def tp_checks(rank, world, params, batch):
    """On one rank: every check of this module that runs in the ranks."""
    torch.set_num_threads(1)
    from torch.distributed.tensor import Replicate, distribute_tensor

    from torch_asg_tpu_torch.parallel import make_mesh

    jmesh = make_mesh(JAX_MESH[world], ("data", "model"), device="cpu")
    dmesh = make_mesh(DATA_MESH[world], ("data", "model"), device="cpu")
    out = {"coord": tuple(jmesh.get_coordinate())}
    for name, (_, make) in OPTIMIZERS.items():
        out[name] = _steps(_port_model(params), make, jmesh, batch)
        out[f"{name}_data_mesh"] = _steps(_port_model(params), make, dmesh, batch)
    out["conv_calls"] = _conv_calls(_port_model(params), jmesh, batch)

    model = _port_model(params)
    out["adafactor_error"] = _error(
        lambda: shard_train_state(jmesh, model, create_train_state(model, adafactor)))
    out["adafactor_data_mesh"] = _steps(_port_model(params), adafactor, dmesh, batch)

    # dropout: the activation of every block after its gather and mask
    model = _port_model(params, dropout=0.2)
    acts = []
    hooks = [b.register_forward_hook(lambda m, i, o: acts.append(o.detach().numpy().copy()))
             for b in model.blocks]
    out["dropout"] = _steps(model, None, jmesh, batch, steps=2)
    for h in hooks:
        h.remove()
    out["dropout_acts"] = acts

    out["dryrun_loss"] = _dryrun_mirror(world)

    # errors: a mesh without 'model', channels that do not divide over it, a
    # batch that does not divide over 'data'
    flat = make_mesh((world,), ("data",), device="cpu")
    model = _port_model(params)
    out["no_model_axis_shard"] = _error(
        lambda: shard_train_state(flat, model, create_train_state(model)))
    conv = model.blocks[0].conv
    conv.weight = torch.nn.Parameter(distribute_tensor(conv.weight.detach(), flat,
                                                       (Replicate(),)))
    out["no_model_axis_forward"] = _error(
        lambda: model(torch.from_numpy(batch["features"])))
    narrow = Wav2Letter(in_features=FEAT, device="cpu", dtype=torch.float64,
                        **{**CFG, "channels": 3})
    out["channels_error"] = _error(
        lambda: shard_train_state(jmesh, narrow, create_train_state(narrow)))
    model = _port_model(params)
    state = shard_train_state(dmesh, model, create_train_state(model))
    d = dmesh.get_local_rank("data")
    rows = slice(0, 2) if d == 0 else slice(0, 1)  # 2 + 1 + ... rows: not equal blocks
    uneven = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    out["batch_error"] = _error(lambda: make_train_step(model, state.optimizer)(state, uneven))
    return out


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"world{w}")
def tp_ranks(request):
    params = _flax_params()
    return request.param, params, spawn_ranks(tp_checks, request.param, (params, _batch()),
                                              device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _jax_steps(shape, optimizer, params, batch):
    """The JAX package's jitted ``make_train_step`` on a state placed by its
    ``shard_train_state`` over a ('data', 'model') mesh of ``shape``, the
    batch placed ``P('data', ...)``: (losses, port-named parameters)."""
    model = FlaxWav2Letter(**CFG)
    mesh = jax_make_mesh(shape, ("data", "model"),
                         devices=jax.devices("cpu")[:shape[0] * shape[1]])
    jparams = {"encoder": jax.tree_util.tree_map(jnp.asarray, params),
               "transition": jnp.zeros((CFG["num_labels"],) * 2, jnp.float64)}
    state = JaxTrainState(jparams, optimizer.init(jparams), jnp.zeros((), jnp.int32))
    state = jax_shard_train_state(mesh, model, FEAT, state)
    jbatch = {k: jax.device_put(jnp.asarray(v),
                                NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))))
              for k, v in batch.items()}
    step = jax.jit(jax_make_train_step(model, optimizer))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jbatch)
        losses.append(float(loss))
    got = {k: v.numpy() for k, v in wav2letter_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params["encoder"])).items()}
    got["transition"] = np.asarray(state.params["transition"])
    return losses, got


def _single_process(params, make, steps=STEPS, **model_kw):
    """The port's single-process steps on the whole batch: (losses, params)."""
    model = _port_model(params, **model_kw)
    state = create_train_state(model, make)
    step = make_train_step(model, state.optimizer)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses = [float(step(state, batch)[1]) for _ in range(steps)]
    named = [*model.named_parameters(), ("transition", state.transition)]
    return losses, {n: p.detach().numpy() for n, p in named}


def _assert_steps(got, losses, params, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(got["losses"], losses, rtol=rtol)
    assert got["params"].keys() == params.keys()
    for name, want in params.items():
        np.testing.assert_allclose(got["params"][name], want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_tp_steps_match_jax_sharded_step(tp_ranks, opt):
    """Three steps on the (1, 2) and (2, 2) meshes against the JAX package's
    sharded step, on every rank; every parameter keeps its placement."""
    from torch.distributed.tensor import Replicate, Shard

    world, params, ranks = tp_ranks
    losses, want = _jax_steps(JAX_MESH[world], OPTIMIZERS[opt][0](), params, _batch())
    for r in ranks:
        _assert_steps(r[opt], losses, want)
        for name, placements in r[opt]["placements"].items():
            split = name.startswith("blocks.")
            assert placements == (Replicate(), Shard(0) if split else Replicate()), name


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_tp_steps_on_a_data_mesh_match_single_process(tp_ranks, opt):
    """(2, 1) and (4, 1): 'data' alone splits, and the step is the
    single-process step's on the whole batch."""
    world, params, ranks = tp_ranks
    losses, want = _single_process(params, OPTIMIZERS[opt][1])
    for r in ranks:
        _assert_steps(r[f"{opt}_data_mesh"], losses, want)


def test_tp_forward_convolves_local_blocks(tp_ranks):
    """Each rank's convolutions run on plain tensors of its (Cout/M, Cin, K)
    block; the only collectives are the activations' (c10d), none of
    DTensor's redistributions (_c10d_functional): no weight is gathered."""
    world, _, ranks = tp_ranks
    m = JAX_MESH[world][1]
    c, h = CFG["channels"], CFG["head_channels"]
    want = [("Tensor", (c // m, FEAT, 11)), ("Tensor", (c // m, c, 7)),
            ("Tensor", (h // m, c, 7))]
    for r in ranks:
        assert r["conv_calls"]["convs"] == want
        assert r["conv_calls"]["namespaces"] == ["c10d"]


def test_dryrun_multichip_train_step_mirror(tp_ranks):
    """``dryrun_multichip``'s train step: a finite loss, the same on every
    rank."""
    _, _, ranks = tp_ranks
    losses = [r["dryrun_loss"] for r in ranks]
    assert np.isfinite(losses).all() and len(set(losses)) == 1, losses


def test_adafactor_refused_where_split_exact_elsewhere(tp_ranks):
    """A 'model' split makes ``shard_train_state`` refuse Adafactor, naming
    it and the reason; on a (D, 1) mesh its steps are the single-process
    steps within 1e-12 relative."""
    _, params, ranks = tp_ranks
    losses, want = _single_process(params, adafactor)
    for r in ranks:
        assert "torch.optim.Adafactor" in r["adafactor_error"]
        assert "whole-parameter norms" in r["adafactor_error"]
        got = r["adafactor_data_mesh"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-12)
        for name, w in want.items():
            np.testing.assert_allclose(got["params"][name], w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max(), err_msg=name)


def test_tp_dropout_masks_agree_within_a_data_group(tp_ranks):
    """With dropout 0.2 the gathered, masked activations are equal on the
    'model' ranks of a data group, and the two steps are the single-process
    steps with dropout (the same masks, drawn for the whole batch)."""
    world, params, ranks = tp_ranks
    for r in ranks:
        twin = next(q for q in ranks if q["coord"][0] == r["coord"][0])
        assert len(r["dropout_acts"]) == 2 * (CFG["depth"] + 2)  # two steps
        for a, b in zip(r["dropout_acts"], twin["dropout_acts"], strict=True):
            np.testing.assert_array_equal(a, b)
        assert any((a == 0).any() for a in r["dropout_acts"])
    losses, want = _single_process(params, None, steps=2, dropout=0.2)
    for r in ranks:
        _assert_steps(r["dropout"], losses, want)


def test_tp_errors(tp_ranks):
    """A mesh without 'model' (placing the state, or a forward through a
    DTensor weight on it), output channels not divisible by 'model', and a
    batch not divisible by 'data' raise."""
    world, _, ranks = tp_ranks
    m, d = JAX_MESH[world][1], DATA_MESH[world][0]
    for r in ranks:
        assert "mesh has no axis ['model']" in r["no_model_axis_shard"]
        assert "mesh has no axis 'model'" in r["no_model_axis_forward"]
        assert r["channels_error"] == (
            f"layer blocks.0.conv: output channels 3 not divisible by mesh axis 'model' = {m}")
        total = 2 + (d - 1)
        assert r["batch_error"] == f"batch {total} not divisible by mesh axis 'data' = {d}"
