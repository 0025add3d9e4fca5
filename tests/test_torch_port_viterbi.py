"""The PyTorch port's 1-best Viterbi decoder against the JAX package.

The port's ``'pallas'`` tier runs the plain versions of its CUDA kernels
(K10 forward, K11 backtrace) on CPU tensors; the JAX package's runs its
Pallas kernels in interpret mode.  Paths must be bit-identical, ties
included, with -1 at padding frames; scores agree to rtol 1e-12 (fp64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asg_tpu as jx
import torch_asg_tpu_torch as pt
from torch_asg_tpu.ops.pallas import viterbi_kernels as jvk
from torch_asg_tpu_torch.ops import viterbi as pvit
from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as pvk
from torch_asg_tpu_torch.ops.kernels.common import LAUNCHES


def _case(seed, t_total=17, num_batches=5, num_labels=7, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        # small integers make exact ties common at every step
        inputs = rng.integers(-2, 3, size=(t_total, num_batches, num_labels)).astype(np.float64)
        trans = rng.integers(-1, 2, size=(num_labels, num_labels)).astype(np.float64)
    else:
        inputs = rng.normal(size=(t_total, num_batches, num_labels))
        trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    li = np.array([t_total, 12, 1, 9, t_total][:num_batches], np.int32)
    return trans, inputs, li


def _check_decode(trans, inputs, li):
    want = {impl: jx.viterbi_decode(jnp.asarray(trans), jnp.asarray(inputs),
                                    jnp.asarray(li), impl=impl)
            for impl in ("pallas", "xla")}
    for impl in ("pallas", "xla"):
        got = pt.viterbi_decode(torch.from_numpy(trans), torch.from_numpy(inputs),
                                torch.from_numpy(li), impl=impl)
        assert got.paths.dtype == torch.int32
        for w in want.values():
            np.testing.assert_array_equal(got.paths.numpy(), np.asarray(w.paths))
            np.testing.assert_allclose(got.scores.numpy(), np.asarray(w.scores),
                                       rtol=1e-12)
    for b, length in enumerate(li):
        assert (got.paths[length:, b] == -1).all()


@pytest.mark.parametrize("integer", [False, True])
def test_decode_matches_jax(integer):
    _check_decode(*_case(1, integer=integer))


def test_all_labels_tie():
    """Zero transitions and one emission value per frame: every label ties
    at every step, so the lowest label wins throughout."""
    rng = np.random.default_rng(2)
    inputs = np.tile(rng.normal(size=(17, 5, 1)), (1, 1, 7))
    _check_decode(np.zeros((7, 7)), inputs, _case(2)[2])


def test_kernel_plain_versions_match_jax_kernels():
    """The plain versions of K10 and K11 against the Pallas kernels they
    replace: end rows, the whole backpointer tensor, and the path."""
    trans, inputs, li = _case(3, integer=True)
    jd, jbp = jvk.viterbi_forward_pallas(*[jnp.asarray(a) for a in (trans, inputs, li)])
    pd, pbp = pvk.viterbi_forward_plain(*[torch.from_numpy(a) for a in (trans, inputs, li)])
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pbp.numpy(), np.asarray(jbp))
    final = np.asarray(jnp.argmax(jd, axis=1)).astype(np.int32)
    jpath = jvk.viterbi_backtrace_pallas(jnp.asarray(final), jbp, jnp.asarray(li))
    ppath = pvk.viterbi_backtrace_plain(torch.from_numpy(final), pbp, torch.from_numpy(li))
    np.testing.assert_array_equal(ppath.numpy(), np.asarray(jpath))


def test_wrappers_run_plain_versions_on_cpu():
    LAUNCHES.clear()
    trans, inputs, li = [torch.from_numpy(a) for a in _case(4)]
    d_end, bp = pvk.viterbi_forward_pallas(trans, inputs, li)
    want_d, want_bp = pvk.viterbi_forward_plain(trans, inputs, li)
    torch.testing.assert_close(d_end, want_d, rtol=0, atol=0)
    assert torch.equal(bp, want_bp)
    _, final = pvk.argmax_first(d_end, dim=1)
    path = pvk.viterbi_backtrace_pallas(final, bp, li)
    assert torch.equal(path, pvk.viterbi_backtrace_plain(final, bp, li))
    assert not LAUNCHES


def test_auto_is_xla_on_cpu_and_agrees():
    trans, inputs, li = [torch.from_numpy(a) for a in _case(5)]
    auto = pt.viterbi_decode(trans, inputs, li)
    pallas = pt.viterbi_decode(trans, inputs, li, impl="pallas")
    assert torch.equal(auto.paths, pallas.paths)
    torch.testing.assert_close(auto.scores, pallas.scores, rtol=0, atol=0)


def test_chunked_xla_matches(monkeypatch):
    trans, inputs, li = [torch.from_numpy(a) for a in _case(6, num_labels=11)]
    want = pt.viterbi_decode(trans, inputs, li, impl="xla")
    monkeypatch.setattr(pvit, "_CHUNK_MIN_LABELS", 4)
    monkeypatch.setattr(pvit, "_CHUNK_SIZE", 3)
    got = pt.viterbi_decode(trans, inputs, li, impl="xla")
    assert torch.equal(got.paths, want.paths)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=0)


def test_pallas_label_cap_raises():
    n = pvk.VITERBI_KERNEL_MAX_LABELS + 1
    with pytest.raises(ValueError, match="pallas"):
        pt.viterbi_decode(torch.zeros((n, n)), torch.zeros((4, 2, n)), impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        pt.viterbi_decode(torch.zeros((3, 3)), torch.zeros((4, 2, 3)), impl="bogus")


def test_half_precision_inputs_upcast():
    trans, inputs, li = _case(7)
    half = torch.from_numpy(inputs).to(torch.float16)
    got = pt.viterbi_decode(torch.from_numpy(trans), half, torch.from_numpy(li),
                            impl="pallas")
    want = pt.viterbi_decode(torch.from_numpy(trans).float(), half.float(),
                             torch.from_numpy(li), impl="pallas")
    assert got.scores.dtype == torch.float32
    assert torch.equal(got.paths, want.paths)
