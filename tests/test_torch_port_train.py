"""The PyTorch port's training path against the JAX package's.

The host data path (``cmvn`` -> ``pack_frames`` -> ``encode_targets``)
against the JAX package's NumPy arms; three ``make_train_step`` steps of a
small Wav2Letter (channels 16, depth 1) at fp64 against the JAX package's
jitted ``make_train_step`` with ``optax.adamw(3e-4)``, from the same Flax
weights; and, on the port alone, the learning and dropout checks of
``tests/test_train.py``.
"""

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
from torch_asg_tpu.models.train import TrainState as JaxTrainState
from torch_asg_tpu.runtime import host as jhost
from torch_asg_tpu_torch.convert import wav2letter_from_flax
from torch_asg_tpu_torch.models import (Wav2Letter, create_train_state, loss_fn,
                                        make_train_step)
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


def _flax_params():
    model = FlaxWav2Letter(**CFG)
    params = model.init(jax.random.key(0), jnp.zeros((1, 16, FEAT), jnp.float64))
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
