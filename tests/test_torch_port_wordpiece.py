"""Wordpiece-vocabulary training in the PyTorch port against the JAX package.

A small Wav2Letter (channels 16, depth 1) with a 520-label head, past the
fused tier's 512-label width, so ``asg_loss(impl='auto')`` runs the matmul
tier on both sides.  The Flax weights carry across with
``wav2letter_from_flax``; two AdamW steps at fp64 against the JAX package's
jitted ``make_train_step``, with the tolerances of
``tests/test_torch_port_train.py``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_asg_tpu.models import Wav2Letter as FlaxWav2Letter
from torch_asg_tpu.models import make_train_step as jax_make_train_step
from torch_asg_tpu.models.train import TrainState as JaxTrainState
from torch_asg_tpu_torch.convert import wav2letter_from_flax
from torch_asg_tpu_torch.models import Wav2Letter, create_train_state, make_train_step

FEAT = 16
CFG = dict(num_labels=520, channels=16, depth=1, head_channels=16)


def test_wordpiece_train_steps_match_jax():
    rng = np.random.default_rng(0)
    b, t, s = 3, 14, 4
    batch = {
        "features": rng.normal(size=(b, t, FEAT)),
        "feature_lengths": np.array([t, t - 3, t - 6], np.int32),
        "targets": rng.integers(0, CFG["num_labels"], size=(b, s)).astype(np.int32),
        "target_lengths": np.array([s, 2, 3], np.int32),
    }
    jmodel = FlaxWav2Letter(**CFG)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 16, FEAT), jnp.float64))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                    flax.core.meta.unbox(params["params"]))
    jparams = {"encoder": jax.tree_util.tree_map(jnp.asarray, params),
               "transition": jnp.zeros((CFG["num_labels"],) * 2, jnp.float64)}
    opt = optax.adamw(3e-4)
    jstate = JaxTrainState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jmodel, opt))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = Wav2Letter(in_features=FEAT, device="cpu", dtype=torch.float64, **CFG)
    model.load_state_dict(wav2letter_from_flax(params))
    assert model.proj.weight.shape == (CFG["num_labels"], CFG["head_channels"])
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = step(state, tbatch)
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-9)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = wav2letter_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params["encoder"]))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(state.transition.detach().numpy(),
                               np.asarray(jstate.params["transition"]), rtol=0, atol=1e-12)
