"""The PyTorch port's training path against the JAX package's.

The host data path (``cmvn`` -> ``pack_frames`` -> ``encode_targets``)
against the JAX package's NumPy arms; three ``make_train_step`` steps of a
small Wav2Letter (channels 16, depth 1) at fp64 against the JAX package's
jitted ``make_train_step`` with ``optax.adamw(3e-4)``, from the same Flax
weights; and, on the port alone, the learning and dropout checks of
``tests/test_train.py``.  The twins of its sharding and checkpoint tests:
``shard_train_state`` in spawned gloo ranks on the CPU (2 and 4 ranks, a
(P/2) x 2 'data' x 'model' mesh, one spawn each with its own timeout)
against the JAX package's partitioning metadata, and a ``torch.save`` /
``torch.load`` round trip that resumes bit for bit.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_asg_tpu_torch as pt
from torch_asg_tpu.models import Wav2Letter as FlaxWav2Letter
from torch_asg_tpu.models import make_train_step as jax_make_train_step
from torch_asg_tpu.models.train import encoder_partition_specs as jax_partition_specs
from torch_asg_tpu.models.train import TrainState as JaxTrainState
from torch_asg_tpu.runtime import host as jhost
from torch_asg_tpu_torch.convert import wav2letter_from_flax
from torch_asg_tpu_torch.models import (Wav2Letter, create_train_state, loss_fn,
                                        make_train_step, param_shardings,
                                        shard_train_state)
from torch_asg_tpu_torch.parallel.launch import spawn_ranks
from torch_asg_tpu_torch.runtime import cmvn, encode_labels_np, encode_targets, pack_frames

FEAT = 16
CFG = dict(num_labels=8, channels=16, depth=1, head_channels=16)


def _utterances(rng, n=5):
    return [(rng.normal(size=(int(rng.integers(1, 30)), FEAT)) * rng.uniform(0.5, 3.0)
             + rng.normal()).astype(np.float32) for _ in range(n)]


def test_cmvn_and_pack_frames_match_jax():
    rng = np.random.default_rng(0)
    utts = _utterances(rng) + [np.zeros((0, FEAT), np.float32)]
    for norm_var in (True, False):
        got = cmvn(utts, norm_var=norm_var)
        want = jhost.cmvn(utts, norm_var=norm_var, use_native=False)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    for pad in (0.0, -1.5):
        got = pack_frames(cmvn(utts), pad_value=pad)
        want = jhost.pack_frames(jhost.cmvn(utts, use_native=False), pad_value=pad,
                                 use_native=False)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_encode_targets_match_jax():
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 4, size=int(rng.integers(0, 25))) for _ in range(20)]
    seqs.append(np.array([3, 3, 3, 3, 3, 3, 3, 1, 1, 2]))
    for max_reps in (1, 2, 3):
        for s in seqs:
            np.testing.assert_array_equal(encode_labels_np(s, 28, max_reps),
                                          jhost.encode_labels_np(s, 28, max_reps))
        got = encode_targets(seqs, 28, max_reps, pad_value=-1)
        want = jhost.encode_targets(seqs, 28, max_reps, pad_value=-1, use_native=False)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_host_data_path_edge_cases():
    out, lengths = pack_frames([])
    assert out.size == 0 and lengths.size == 0
    tgts, tlens = encode_targets([], alphabet_size=26)
    assert tgts.shape == (0, 1) and tlens.size == 0
    assert cmvn([]) == []
    mixed = [np.zeros((10, 8), np.float32), np.zeros((5, 4), np.float32)]
    for fn in (pack_frames, cmvn):
        with pytest.raises(ValueError, match="feature dim"):
            fn(mixed)


def _batch(rng, b=3, t=14, s=4):
    return {
        "features": rng.normal(size=(b, t, FEAT)),
        "feature_lengths": np.array([t, t - 3, t - 6][:b], np.int32),
        "targets": rng.integers(0, CFG["num_labels"], size=(b, s)).astype(np.int32),
        "target_lengths": np.array([s, 2, 3][:b], np.int32),
    }


def _flax_params(key=0):
    model = FlaxWav2Letter(**CFG)
    params = model.init(jax.random.key(key), jnp.zeros((1, 16, FEAT), jnp.float64))
    return model, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), flax.core.meta.unbox(params["params"]))


def _port_model(params, **kw):
    model = Wav2Letter(in_features=FEAT, device="cpu", dtype=torch.float64, **CFG, **kw)
    model.load_state_dict(wav2letter_from_flax(params))
    return model


def test_train_steps_match_jax():
    """Three AdamW steps, fp64, from the same weights: losses at every step
    within 1e-9 relative and parameters at the end within 1e-12 absolute.
    Adam divides each gradient entry by its own root mean square, so
    gradients that agree to ~1e-12 relative move a parameter (by about lr =
    3e-4 a step) the same to ~1e-16; the bound leaves room for the sums
    taken in another order in the convolutions (a gradient entry that is 0
    on one side and rounding noise on the other would move by lr instead)."""
    jmodel, params = _flax_params()
    batch = _batch(np.random.default_rng(2))
    # the JAX TrainState by hand: create_train_state makes an fp32 transition
    jparams = {"encoder": jax.tree_util.tree_map(jnp.asarray, params),
               "transition": jnp.zeros((CFG["num_labels"],) * 2, jnp.float64)}
    opt = optax.adamw(3e-4)
    jstate = JaxTrainState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jmodel, opt))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = _port_model(params)
    state = create_train_state(model)
    assert state.transition.dtype == torch.float64
    step = make_train_step(model, state.optimizer)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = step(state, tbatch)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-9)
    assert state.step == 3
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = wav2letter_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params["encoder"]))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(state.transition.detach().numpy(),
                               np.asarray(jstate.params["transition"]), rtol=0, atol=1e-12)


def test_default_optimizer_is_optax_adamw():
    model = Wav2Letter(in_features=FEAT, device="cpu", **CFG)
    state = create_train_state(model)
    (group,) = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.999), 1e-8, 1e-4)
    assert group["params"][-1] is state.transition
    assert (state.transition == 0).all() and state.transition.dtype == torch.float32


def test_asg_training_drives_decode_to_target():
    """test_train.py's learning check on the port: jointly optimising the
    emissions and the transition under the ASG loss (fused tier) drives the
    loss toward zero and the Viterbi decode to the target sequence."""
    rng = np.random.default_rng(3)
    t_total, num_batches, num_labels = 24, 2, 6
    targets = torch.tensor([[1, 2, 3], [4, 0, 5]], dtype=torch.int32)
    lo = torch.full((num_batches,), 3, dtype=torch.int32)
    li = torch.full((num_batches,), t_total, dtype=torch.int32)
    inputs = torch.tensor(0.1 * rng.normal(size=(t_total, num_batches, num_labels)),
                          requires_grad=True)
    trans = torch.zeros((num_labels, num_labels), dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([inputs, trans], lr=0.2)

    def loss():
        return pt.asg_loss(trans, inputs, targets, li, lo, reduction="mean")

    with torch.no_grad():
        first = float(loss())
    for _ in range(120):
        opt.zero_grad()
        loss().backward()
        opt.step()
    with torch.no_grad():
        last = float(loss())
        paths = pt.viterbi_decode(trans, inputs, li).paths.numpy()
    assert last < 0.05 * first, (first, last)
    for b in range(num_batches):
        runs = [lab for i, lab in enumerate(paths[:, b]) if i == 0 or lab != paths[i - 1, b]]
        assert runs == targets[b].tolist(), (b, runs)


def test_dropout_actually_fires():
    """A dropout-configured model trains with active dropout whose masks
    change from step to step; evaluation stays deterministic."""
    _, params = _flax_params()
    model = _port_model(params, dropout=0.5)
    state = create_train_state(model, lambda p: torch.optim.SGD(p, lr=0.0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(4)).items()}
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        eval_loss = float(loss_fn(model, state, batch))
        assert float(loss_fn(model, state, batch)) == eval_loss
        train_a = float(loss_fn(model, state, batch, train=True, generator=gen))
        train_b = float(loss_fn(model, state, batch, train=True, generator=gen))
    assert train_a != eval_loss and train_a != train_b
    # lr 0 keeps the parameters, so only the masks tell the steps apart
    step = make_train_step(model, state.optimizer)
    state, l1 = step(state, batch)
    state, l2 = step(state, batch)
    assert float(l1) != float(l2)
    # the same seed gives the same masks
    again = make_train_step(model, state.optimizer, generator=torch.Generator().manual_seed(0))
    _, l1_again = again(state, batch)
    assert float(l1_again) == float(l1)


def test_dropout_free_model_is_deterministic():
    _, params = _flax_params()
    model = _port_model(params)
    state = create_train_state(model, lambda p: torch.optim.SGD(p, lr=0.0))
    step = make_train_step(model, state.optimizer)
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(5)).items()}
    _, l1 = step(state, batch)
    _, l2 = step(state, batch)
    assert float(l1) == float(l2)


def test_pallas_train_steps_match_jax():
    """``make_train_step(impl='pallas')``: three AdamW steps of the
    per-lattice tier (K3, K6, K7 forward and K5, K8 backward, as plain
    versions on CPU tensors) against the JAX package's jitted
    ``make_train_step(impl='pallas')`` (its Pallas kernels in interpret
    mode), fp64, from the same weights: the bounds of
    ``test_train_steps_match_jax``."""
    jmodel, params = _flax_params()
    batch = _batch(np.random.default_rng(6))
    jparams = {"encoder": jax.tree_util.tree_map(jnp.asarray, params),
               "transition": jnp.zeros((CFG["num_labels"],) * 2, jnp.float64)}
    opt = optax.adamw(3e-4)
    jstate = JaxTrainState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jmodel, opt, impl="pallas"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = _port_model(params)
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer, impl="pallas")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = step(state, tbatch)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-9)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = wav2letter_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params["encoder"]))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(state.transition.detach().numpy(),
                               np.asarray(jstate.params["transition"]), rtol=0, atol=1e-12)


# --- sharding over a mesh, and checkpoints ------------------------------------

SPAWN_TIMEOUT_S = 300
OPTIMIZERS = {"adamw": None, "adafactor": lambda p: torch.optim.Adafactor(p, lr=1e-3)}


def shard_checks(rank, world, params):
    """On one rank: for each optimizer, one step (so the optimizer has its
    state), then ``shard_train_state`` onto a (world/2) x 2 mesh, and one
    more step of the sharded state and of an unsharded copy from the same
    gradients; the placements and both results as numpy, or the error that
    refused the optimizer."""
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, distribute_tensor

    from torch_asg_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world // 2, 2), ("data", "model"), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(8)).items()}
    out = {}
    for name, make in OPTIMIZERS.items():
        model = _port_model(params)
        state = create_train_state(model, make)
        state, _ = make_train_step(model, state.optimizer, impl="scan")(state, batch)
        ref = copy.deepcopy(state)
        names = [n for n, _ in model.named_parameters()] + ["transition"]
        gen = torch.Generator().manual_seed(9)
        grads = [torch.randn(p.shape, generator=gen, dtype=p.dtype)
                 for p in [*model.parameters(), state.transition]]
        try:
            sharded = shard_train_state(mesh, model, state)
        except ValueError as e:
            out[name] = {"error": str(e), "still_plain": not any(
                isinstance(p, DTensor) for p in [*model.parameters(), state.transition])}
            continue
        params_after = [*model.parameters(), sharded.transition]
        out[name] = {
            "placements": {n: p.placements for n, p in zip(names, params_after)},
            "state": {n: {k: (tuple(v.shape), v.placements)
                          for k, v in sharded.optimizer.state[p].items()}
                      for n, p in zip(names, params_after)},
            "shardings": param_shardings(mesh, model),
        }
        for p, g in zip(params_after, grads):
            p.grad = distribute_tensor(g, mesh, p.placements)
        sharded.optimizer.step()
        for p, g in zip([*ref.model.parameters(), ref.transition], grads):
            p.grad = g
        ref.optimizer.step()
        out[name]["stepped"] = [p.detach().full_tensor().numpy() for p in params_after]
        out[name]["ref"] = [p.detach().numpy() for p in [*ref.model.parameters(),
                                                          ref.transition]]
    return out


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"world{w}")
def shard_ranks(request):
    _, params = _flax_params()
    return request.param, spawn_ranks(shard_checks, request.param, (params,),
                                      device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _port_name(jax_path):
    """('ConvBlock_1', 'Conv_0', 'kernel') -> 'blocks.1.conv.weight';
    ('Dense_0', 'bias') -> 'proj.bias'."""
    block, leaf = jax_path[0], {"kernel": "weight", "bias": "bias"}[jax_path[-1]]
    if block.startswith("ConvBlock_"):
        return f"blocks.{block.split('_')[1]}.conv.{leaf}"
    return f"proj.{leaf}"


def test_partition_specs_follow_the_flax_metadata():
    """Each parameter splits over 'model' exactly where the JAX package's
    partitioning metadata does: a Flax conv kernel (K, Cin, Cout) splits its
    last dim and its bias its only one, which are dim 0 of the torch weight
    (Cout, Cin, K) and bias; the head projection replicates."""
    from torch.distributed.tensor import Shard

    from torch_asg_tpu_torch.models import encoder_partition_specs

    jspecs = jax_partition_specs(FlaxWav2Letter(**CFG), FEAT)
    flat = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec) or x is None)
    got = encoder_partition_specs(Wav2Letter(in_features=FEAT, device="cpu", **CFG))
    assert len(flat) == len(got)
    for path, spec in flat:
        name = _port_name(tuple(k.key for k in path))
        jax_model_dims = [i for i, a in enumerate(spec or ()) if a == "model"]
        if jax_model_dims:
            assert jax_model_dims == [len(spec) - 1]  # output channels
            assert got[name] == {"model": Shard(0)}, name
        else:
            assert got[name] == {}, name


def test_optimizer_moments_follow_param_shardings(shard_ranks):
    """AdamW's moments take their parameter's placements (not replicated:
    per-rank optimizer memory shrinks with the parameters); the step counter
    replicates; and a step of the sharded state equals the unsharded step
    bit for bit."""
    from torch.distributed.tensor import Replicate

    world, ranks = shard_ranks
    for r in ranks:
        got = r["adamw"]
        shardings = got["shardings"]
        want = {**shardings["encoder"], "transition": shardings["transition"]}
        assert got["placements"] == want
        assert any(any(not isinstance(x, Replicate) for x in pl) for pl in want.values())
        for name, st in got["state"].items():
            assert st["exp_avg"][1] == want[name] and st["exp_avg_sq"][1] == want[name]
            assert st["step"] == ((), (Replicate(), Replicate()))
        for a, b in zip(got["stepped"], got["ref"]):
            np.testing.assert_array_equal(a, b)


def test_shard_train_state_handles_factored_optimizer(shard_ranks):
    """Adafactor on a state split over 'model' is refused with a ValueError
    that names it and the reason (its step size and update clipping take
    whole-parameter norms through ``.item()``, which reads one rank's block
    of a split DTensor: its sharded step was off by 1e-4), before anything
    is placed.  Its exact steps on a (D, 1) mesh are in
    ``tests/test_torch_port_tp_train.py``."""
    world, ranks = shard_ranks
    for r in ranks:
        got = r["adafactor"]
        assert got["error"].startswith(
            "torch.optim.Adafactor cannot step a state split over mesh axis 'model' = 2")
        assert "whole-parameter norms through .item()" in got["error"]
        assert got["still_plain"]


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    """torch.save of the state_dicts (model, transition, Adam) and the step
    -> torch.load into a FRESH state -> one more step equals an
    uninterrupted two-step run bit for bit."""
    _, params = _flax_params()
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(10)).items()}

    def fresh(p):
        model = _port_model(p)
        state = create_train_state(model, lambda ps: torch.optim.Adam(ps, lr=1e-2))
        return state, make_train_step(model, state.optimizer)

    state, step = fresh(params)
    state, _ = step(state, batch)
    state, loss_straight = step(state, batch)

    s1, step1 = fresh(params)
    s1, _ = step1(s1, batch)
    path = tmp_path / "ckpt.pt"
    torch.save({"model": s1.model.state_dict(), "transition": s1.transition.detach(),
                "optimizer": s1.optimizer.state_dict(), "step": s1.step}, path)

    s2, step2 = fresh(_flax_params(key=7)[1])  # other weights, no optimizer state
    ckpt = torch.load(path, weights_only=True)
    s2.model.load_state_dict(ckpt["model"])
    with torch.no_grad():
        s2.transition.copy_(ckpt["transition"])
    s2.optimizer.load_state_dict(ckpt["optimizer"])
    s2.step = ckpt["step"]
    s2, loss_resumed = step2(s2, batch)

    assert s2.step == state.step == 2
    assert torch.equal(loss_resumed, loss_straight)
    for a, b in zip([*state.model.parameters(), state.transition],
                    [*s2.model.parameters(), s2.transition]):
        assert torch.equal(a, b)
    for pa, pb in zip([*state.model.parameters(), state.transition],
                      [*s2.model.parameters(), s2.transition]):
        sa, sb = state.optimizer.state[pa], s2.optimizer.state[pb]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    # the criterion's own learned parameter moved and survived the trip
    assert bool((s2.transition != 0).any())
