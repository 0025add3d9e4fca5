"""The port's reference-signature shims (``compat``, ``torch_compat``)
against the JAX package's.

``tests/test_compat.py`` is mirrored with the contract a native module has
(the JAX shim can only return zero gradients in eval mode; the port's module
raises on ``.backward()`` there, as the reference does), together with the
parts of ``tests/test_torch_compat.py`` that apply to a module running
natively: eval-mode backward, the spread guard, a ``state_dict`` round trip
and ``load_reference_transition``.  Losses and gradients are held against
the JAX package's ``asg_loss`` at fp64 (rtol 1e-12 for losses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asg_tpu import asg_loss as jax_asg_loss
from torch_asg_tpu.torch_compat import load_reference_transition as jax_load_transition
from torch_asg_tpu_torch import asg
from torch_asg_tpu_torch.compat import ASGLoss
from torch_asg_tpu_torch.torch_compat import ASGLoss as TorchASGLoss
from torch_asg_tpu_torch.torch_compat import load_reference_transition

F64 = dict(device="cpu", dtype=torch.float64)


def _case(rng, t_total=8, num_labels=5, s_total=3):
    inputs = rng.normal(size=(t_total, 2, num_labels))
    targets = rng.integers(0, num_labels, size=(2, s_total)).astype(np.int32)
    return inputs, targets


def _module(num_labels, trans=None, **kwargs):
    crit = ASGLoss(num_labels, **kwargs, **F64)
    if trans is not None:
        with torch.no_grad():
            crit.transition.copy_(torch.from_numpy(trans))
    return crit


def test_shims_are_the_ports_module():
    assert ASGLoss is TorchASGLoss is asg.ASGLoss


def test_readme_example_shapes(rng):
    num_labels = 7
    crit = _module(num_labels, reduction="mean")
    inputs = rng.normal(size=(6, 2, num_labels))
    targets = np.asarray([[1, 2, 3, 3, 5], [4, 3, 2, 2, 1]], np.int32)
    input_lengths = np.asarray([6, 5], np.int32)
    target_lengths = np.asarray([5, 4], np.int32)
    loss = crit(*map(torch.from_numpy, (inputs, targets, input_lengths, target_lengths)))
    assert loss.shape == () and np.isfinite(loss.item())
    ref = jax_asg_loss(jnp.zeros((num_labels, num_labels)), jnp.asarray(inputs),
                       jnp.asarray(targets), jnp.asarray(input_lengths),
                       jnp.asarray(target_lengths), reduction="mean")
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-12)


def test_gpu_no_stream_impl_maps_to_scan(rng):
    crit_fast = _module(5)
    crit_serial = _module(5, gpu_no_stream_impl=True)
    assert crit_serial.impl == "scan" and crit_fast.impl == "auto"
    inputs, targets = _case(rng)
    x, y = torch.from_numpy(inputs), torch.from_numpy(targets)
    np.testing.assert_allclose(crit_fast(x, y).item(), crit_serial(x, y).item(), rtol=1e-9)


def test_forward_only_blocks_grad(rng):
    """forward_only scores under no_grad: nothing to differentiate, and
    ``.backward()`` raises (the reference's contract)."""
    crit = _module(5, forward_only=True)
    inputs, targets = _case(rng)
    x = torch.from_numpy(inputs).requires_grad_(True)
    loss = crit(x, torch.from_numpy(targets))
    assert not loss.requires_grad
    with pytest.raises(RuntimeError):
        loss.backward()


def test_transition_is_trainable_leaf(rng):
    crit = _module(5, reduction="sum")
    assert isinstance(crit.transition, torch.nn.Parameter) and crit.transition.is_leaf
    inputs, targets = _case(rng)
    crit(torch.from_numpy(inputs), torch.from_numpy(targets)).backward()
    assert (crit.transition.grad != 0).any()


def test_unknown_reduction_raises():
    with pytest.raises(ValueError, match="reduction"):
        ASGLoss(5, reduction="bogus", **F64)


def test_eval_mode_takes_score_only_path(rng):
    """Eval mode scores under no_grad, with the same losses as train mode;
    train mode differentiates again."""
    crit = _module(5)
    assert crit.training is True
    inputs, targets = _case(rng)
    x, y = torch.from_numpy(inputs), torch.from_numpy(targets)
    assert crit.eval() is crit and crit.training is False
    loss_eval = crit(x, y)
    assert not loss_eval.requires_grad
    crit.train()
    assert crit.training is True
    loss_train = crit(x, y)
    np.testing.assert_allclose(loss_eval.item(), loss_train.item(), rtol=1e-12)
    loss_train.backward()
    assert (crit.transition.grad != 0).any()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_loss_and_grads_match_jax(rng, reduction):
    inputs, targets = _case(rng)
    trans = rng.normal(size=(5, 5)) * 0.5
    li, lo = np.asarray([8, 7], np.int32), np.asarray([3, 2], np.int32)
    crit = _module(5, trans, reduction=reduction)
    x = torch.from_numpy(inputs).requires_grad_(True)
    loss = crit(x, *map(torch.from_numpy, (targets, li, lo)))
    loss.sum().backward()

    def jloss(t, i):
        return jax_asg_loss(t, i, jnp.asarray(targets), jnp.asarray(li), jnp.asarray(lo),
                            reduction=reduction)

    want = jloss(jnp.asarray(trans), jnp.asarray(inputs))
    g_t, g_i = jax.grad(lambda t, i: jloss(t, i).sum(), argnums=(0, 1))(
        jnp.asarray(trans), jnp.asarray(inputs))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(crit.transition.grad.numpy(), np.asarray(g_t), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_i), rtol=1e-9, atol=1e-12)


def test_eval_mode_backward_raises_like_reference(rng):
    inputs, targets = _case(rng)
    crit = _module(5, rng.normal(size=(5, 5)) * 0.5)
    x = torch.from_numpy(inputs).requires_grad_(True)
    crit.eval()
    loss_eval = crit(x, torch.from_numpy(targets))
    assert not loss_eval.requires_grad
    with pytest.raises(RuntimeError):
        loss_eval.backward()
    crit.train()
    np.testing.assert_allclose(loss_eval.item(), crit(x, torch.from_numpy(targets)).item(),
                               rtol=1e-12)


def test_spread_guard_through_the_module(rng):
    inputs, targets = _case(rng)
    x, y = torch.from_numpy(inputs), torch.from_numpy(targets)
    crit = _module(5, impl="fused")
    with torch.no_grad():
        crit.transition[0, 0] = 150.0
    with pytest.raises(ValueError, match="spread"):
        crit(x, y)
    crit_auto = _module(5)
    with torch.no_grad():
        crit_auto.transition[0, 0] = 150.0
    out = crit_auto(x, y)
    assert np.isfinite(out.item())
    want = jax_asg_loss(jnp.asarray(crit_auto.transition.detach().numpy()), jnp.asarray(inputs),
                        jnp.asarray(targets), reduction="mean")
    np.testing.assert_allclose(out.item(), float(want), rtol=1e-12)


def test_state_dict_roundtrip():
    crit = _module(5)
    with torch.no_grad():
        crit.transition.copy_(torch.randn(5, 5, dtype=torch.float64))
    sd = crit.state_dict()
    assert list(sd) == ["transition"]
    crit2 = _module(5)
    crit2.load_state_dict(sd)
    assert torch.equal(crit2.transition, crit.transition)


def test_load_reference_transition(rng, tmp_path):
    """A reference checkpoint (the single 'transition' parameter) loads as a
    mapping, from a file and under a prefix, equal to
    the JAX package's helper, and drops into ``load_state_dict``."""
    n = 6
    ref_t = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    sd = {"transition": ref_t}
    got = load_reference_transition(sd)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref_t.numpy())
    np.testing.assert_array_equal(got, jax_load_transition(sd))

    path = tmp_path / "ref_ckpt.pt"
    torch.save(sd, path)
    np.testing.assert_array_equal(load_reference_transition(path), ref_t.numpy())
    np.testing.assert_array_equal(load_reference_transition(str(path)), ref_t.numpy())

    nested = {"criterion.transition": ref_t.double(), "encoder.w": torch.zeros(2)}
    got = load_reference_transition(nested, prefix="criterion.")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref_t.numpy())
    with pytest.raises(KeyError, match="transition"):
        load_reference_transition(nested)
    with pytest.raises(ValueError, match="square"):
        load_reference_transition({"transition": torch.zeros(2, 3)})

    module = ASGLoss(n, device="cpu")
    module.load_state_dict(sd)
    np.testing.assert_array_equal(module.transition.detach().numpy(), ref_t.numpy())
    np.testing.assert_array_equal(load_reference_transition(module.state_dict()), ref_t.numpy())
