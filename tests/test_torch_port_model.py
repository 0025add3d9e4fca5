"""The PyTorch port's Wav2Letter encoder against the JAX package's Flax one.

Flax params from ``jax.random.key(0)`` go through numpy and
``convert.wav2letter_from_flax`` into the port.  Odd and even feature
lengths cover the asymmetric "SAME" padding of the stride-2 frontend.
Everything is fp64; emissions agree within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asg_tpu.models import Wav2Letter as FlaxWav2Letter
from torch_asg_tpu_torch.convert import transition_from_numpy, wav2letter_from_flax
from torch_asg_tpu_torch.models import Wav2Letter
from torch_asg_tpu_torch.models.wav2letter import same_padding

CFG = dict(num_labels=12, channels=32, depth=2, head_channels=32,
           frontend_kernel=11, frontend_stride=2, kernel=7)
FEATURES = 8


def _unbox(params):
    import flax

    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))


@pytest.mark.parametrize("length", [17, 20])
def test_emissions_match_flax(length):
    flax_model = FlaxWav2Letter(**CFG)
    params = flax_model.init(jax.random.key(0), jnp.zeros((1, 16, FEATURES), jnp.float64))
    port = Wav2Letter(in_features=FEATURES, device="cpu", dtype=torch.float64, **CFG)
    port.load_state_dict(wav2letter_from_flax(_unbox(params)))
    feats = np.random.default_rng(length).normal(size=(3, length, FEATURES))
    want = np.asarray(flax_model.apply(params, jnp.asarray(feats)))
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (-(-length // 2), 3, CFG["num_labels"])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert port.output_length(length) == flax_model.output_length(length)


def test_output_length_on_tensors():
    port = Wav2Letter(in_features=FEATURES, device="cpu", **CFG)
    flax_model = FlaxWav2Letter(**CFG)
    lengths = np.array([1, 2, 3, 999, 1000, 2000])
    got = port.output_length(torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, flax_model.output_length(lengths))


@pytest.mark.parametrize("length,kernel,stride", [(17, 11, 2), (20, 11, 2), (9, 7, 1), (4, 11, 2)])
def test_same_padding_matches_lax(length, kernel, stride):
    pads = jax.lax.padtype_to_pads((length,), (kernel,), (stride,), "SAME")
    assert same_padding(length, kernel, stride) == tuple(pads[0])


def test_transition_from_numpy():
    t = np.arange(9.0).reshape(3, 3)
    got = transition_from_numpy(t, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), t)
