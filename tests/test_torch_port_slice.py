"""The port's serving slice end to end on the CPU against the same flow in
JAX: Wav2Letter encoder -> Viterbi decode -> collapse -> ASG scores.

Small widths (channels 32, depth 2), fp64, weights from ``jax.random.key(0)``
carried over with ``convert.wav2letter_from_flax``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.models import Wav2Letter as FlaxWav2Letter
from torch_asg_tpu.runtime import collapse_path as jax_collapse_path
from torch_asg_tpu_torch.convert import transition_from_numpy, wav2letter_from_flax
from torch_asg_tpu_torch.models import Wav2Letter
from torch_asg_tpu_torch.runtime import collapse_path

ALPHABET, MAX_REPS = 10, 2
CFG = dict(num_labels=ALPHABET + MAX_REPS, channels=32, depth=2, head_channels=32)
FEATURES, B, T_FEAT, S = 8, 4, 30, 6


def test_serving_slice_matches_jax():
    rng = np.random.default_rng(0)
    flax_model = FlaxWav2Letter(**CFG)
    params = flax_model.init(jax.random.key(0), jnp.zeros((1, T_FEAT, FEATURES), jnp.float64))
    port = Wav2Letter(in_features=FEATURES, device="cpu", dtype=torch.float64, **CFG)
    port.load_state_dict(wav2letter_from_flax(
        jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))))

    feats = rng.normal(size=(B, T_FEAT, FEATURES))
    feat_lengths = np.array([30, 23, 11, 4])
    trans = rng.normal(size=(CFG["num_labels"],) * 2) * 0.3
    targets = rng.integers(0, CFG["num_labels"], size=(B, S)).astype(np.int32)
    target_lengths = np.array([6, 4, 5, 1], np.int32)

    # JAX flow
    em_j = flax_model.apply(params, jnp.asarray(feats))
    li_j = jnp.asarray(flax_model.output_length(feat_lengths), jnp.int32)
    dec_j = jx.viterbi_decode(jnp.asarray(trans), em_j, li_j, impl="pallas")
    full_j, aligned_j = jx.asg_scores(jnp.asarray(trans), em_j, jnp.asarray(targets),
                                      li_j, jnp.asarray(target_lengths))
    loss_j = jx.asg_loss(jnp.asarray(trans), em_j, jnp.asarray(targets), li_j,
                         jnp.asarray(target_lengths), reduction="none")

    # port flow, on the CPU
    t = transition_from_numpy(trans, device="cpu")
    with torch.no_grad():
        em = port(torch.from_numpy(feats))
        li = port.output_length(torch.from_numpy(feat_lengths)).to(torch.int32)
        dec = pt.viterbi_decode(t, em, li, impl="pallas")
        full, aligned = pt.asg_scores(t, em, torch.from_numpy(targets), li,
                                      torch.from_numpy(target_lengths))
        loss = pt.asg_loss(t, em, torch.from_numpy(targets), li,
                           torch.from_numpy(target_lengths), reduction="none")

    np.testing.assert_allclose(em.numpy(), np.asarray(em_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(li.numpy(), np.asarray(li_j))
    np.testing.assert_array_equal(dec.paths.numpy(), np.asarray(dec_j.paths))
    np.testing.assert_allclose(dec.scores.numpy(), np.asarray(dec_j.scores), rtol=1e-12)
    for b in range(B):
        got = collapse_path(dec.paths[:, b], ALPHABET, MAX_REPS)
        want = jax_collapse_path(np.asarray(dec_j.paths)[:, b], ALPHABET, MAX_REPS,
                                 use_native=False)
        np.testing.assert_array_equal(got, want)
    for g, w in ((full, full_j), (aligned, aligned_j), (loss, loss_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)
    assert (full.numpy() >= aligned.numpy() - 1e-9).all()


@pytest.mark.parametrize("alphabet_size", [0, 28])
def test_collapse_path_matches_jax(alphabet_size):
    rng = np.random.default_rng(alphabet_size)
    for _ in range(20):
        path = rng.integers(-1, 30, size=int(rng.integers(0, 40))).astype(np.int32)
        path[rng.random(path.shape) < 0.3] = 28  # runs and repeat symbols
        want = jax_collapse_path(path, alphabet_size, MAX_REPS, use_native=False)
        np.testing.assert_array_equal(collapse_path(path, alphabet_size, MAX_REPS), want)
        np.testing.assert_array_equal(
            collapse_path(torch.from_numpy(path), alphabet_size, MAX_REPS), want)
