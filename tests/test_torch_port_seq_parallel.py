"""The port's sequence-parallel (time-split) ASG against the JAX package's.

Mirrors the 6 tests of ``tests/test_seq_parallel.py``: each world size (2
and 4 gloo ranks on the CPU) is one spawn that runs every check of this
module; each test holds the ranks' results against the JAX
``asg_loss_seq`` on a JAX 'seq' mesh of the same size, from the same
seeded numpy inputs.  Every rank passes its block of T/P frames and gets
the whole loss; its emission gradient is its block of the JAX gradient,
its transition gradient the whole of it.  ``test_seq_under_jit_with_sharded_inputs``
has no ``jit`` in the port: its twin runs the same check eagerly.  One more
test runs the chunk programs and the fold in one process, the gather
replaced by stacking (what ``chip_smoke.py`` runs on the card).

Tolerances: fp64 rtol 1e-10 (gradients with an atol of 1e-13 near zero);
the bf16 case in float32 on both sides, rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asg_tpu import asg_loss as jax_asg_loss
from torch_asg_tpu.parallel import asg_loss_seq as jax_asg_loss_seq
from torch_asg_tpu.parallel import make_mesh as jax_make_mesh
from torch_asg_tpu_torch.parallel.launch import spawn_ranks

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300
RTOL, GRAD_ATOL = 1e-10, 1e-13
BF16_TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, t_total, num_batches, s_total, num_labels, lis=None, los=None):
    inputs = rng.normal(size=(t_total, num_batches, num_labels))
    trans = rng.normal(size=(num_labels, num_labels)) * 0.5
    targets = rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32)
    li = np.asarray(lis if lis is not None
                    else rng.integers(s_total, t_total + 1, size=(num_batches,)), np.int32)
    lo = np.asarray(los if los is not None
                    else rng.integers(1, s_total + 1, size=(num_batches,)), np.int32)
    return dict(trans=trans, inputs=inputs, targets=targets, li=li, lo=lo)


def _cases(world):
    rng = np.random.default_rng(20260816)
    bf16 = dict(inputs=torch.tensor(rng.normal(size=(8, 2, 5)), dtype=torch.bfloat16)
                .float().numpy(),
                trans=(rng.normal(size=(5, 5)) * 0.3).astype(np.float32),
                targets=rng.integers(0, 5, size=(2, 10)).astype(np.int32))  # S > T
    return dict(
        scan=_case(rng, 16, 3, 4, 5),
        interior=_case(rng, 16, 4, 3, 5, lis=[3, 7, 12, 16], los=[2, 3, 3, 1]),
        grads=_case(rng, 12, 3, 4, 6, lis=[5, 12, 9]),
        indivisible=_case(rng, 2 * world + 1, 2, 3, 5),
        eager=_case(rng, 16, 2, 3, 5),
        bf16=bf16,
    )


def _t(case, dtype=None):
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype if k == "inputs" else None)
            for k, v in case.items()}


def _frames(x, world, rank):
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def rank_checks(rank, world, cases):
    """Every check of this module on one rank; numpy results."""
    torch.set_num_threads(1)
    from torch_asg_tpu_torch.parallel import asg_loss_seq, make_mesh

    mesh = make_mesh((world,), ("seq",), device="cpu")
    out = {}

    def loss(c, reduction="none", **kw):
        return asg_loss_seq(mesh, c["trans"], _frames(c["inputs"], world, rank),
                            c["targets"], c.get("li"), c.get("lo"), reduction=reduction,
                            **kw)

    for name in ("scan", "interior"):
        out[name] = loss(_t(cases[name])).numpy()
    out["eager"] = loss(_t(cases["eager"]), "mean").numpy()
    out["bf16"] = loss(_t(cases["bf16"], torch.bfloat16)).numpy()

    c = _t(cases["grads"])
    tr = c["trans"].clone().requires_grad_(True)
    x = _frames(c["inputs"], world, rank).clone().requires_grad_(True)
    asg_loss_seq(mesh, tr, x, c["targets"], c["li"], c["lo"], reduction="sum").backward()
    out["grads"] = (tr.grad.numpy(), x.grad.numpy())

    c = _t(cases["indivisible"])
    block = np.array_split(np.arange(c["inputs"].shape[0]), world)[rank]
    try:
        asg_loss_seq(mesh, c["trans"], c["inputs"][block], c["targets"], c["li"], c["lo"])
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    return request.param


@pytest.fixture(scope="module")
def cases(world):
    return _cases(world)


@pytest.fixture(scope="module")
def ranks(world, cases):
    """Every rank's results for this world size (one spawn each)."""
    return spawn_ranks(rank_checks, world, (cases,), device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S)


def _want(world, case, reduction="none"):
    """The JAX function on a mesh of ``world`` devices, jitted (an eager
    shard_map call compiles anew on every call)."""
    mesh = jax_make_mesh((world,), ("seq",), devices=jax.devices("cpu")[:world])
    j = {k: jnp.asarray(v) for k, v in case.items()}
    return jax.jit(lambda *a: jax_asg_loss_seq(mesh, *a, reduction=reduction))(
        j["trans"], j["inputs"], j["targets"], j["li"], j["lo"])


def test_seq_matches_scan(ranks, world, cases):
    want = _want(world, cases["scan"])
    for r in ranks:
        np.testing.assert_allclose(r["scan"], want, rtol=RTOL)


def test_seq_lengths_inside_interior_chunks(ranks, world, cases):
    """L_in ending in chunk 0, in the middle chunks and in the last one."""
    want = _want(world, cases["interior"])
    for r in ranks:
        np.testing.assert_allclose(r["interior"], want, rtol=RTOL)


def test_seq_grads_match_scan(ranks, world, cases):
    c = cases["grads"]
    mesh = jax_make_mesh((world,), ("seq",), devices=jax.devices("cpu")[:world])
    j = {k: jnp.asarray(v) for k, v in c.items()}
    gt, gi = jax.jit(jax.grad(
        lambda tr, x: jax_asg_loss_seq(mesh, tr, x, j["targets"], j["li"], j["lo"],
                                       reduction="sum"), (0, 1)))(j["trans"], j["inputs"])
    for r in ranks:  # the whole transition gradient on every rank, not P times it
        assert np.isfinite(r["grads"][0]).all() and np.isfinite(r["grads"][1]).all()
        np.testing.assert_allclose(r["grads"][0], gt, rtol=RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(np.concatenate([r["grads"][1] for r in ranks]), gi,
                               rtol=RTOL, atol=GRAD_ATOL)


def test_seq_rejects_indivisible_t(ranks, world, cases):
    t_total = 2 * world + 1
    with pytest.raises(ValueError, match="not divisible") as want:
        _want(world, cases["indivisible"])
    for r in ranks:
        assert r["indivisible"] == str(want.value)
        assert f"T {t_total} not divisible by mesh axis 'seq' = {world}" in r["indivisible"]


def test_seq_under_jit_with_sharded_inputs(ranks, world, cases):
    """The JAX test jits the call on time-split inputs; the port has no jit,
    so each rank runs its block eagerly and gets the same mean."""
    want = _want(world, cases["eager"], "mean")
    for r in ranks:
        np.testing.assert_allclose(r["eager"], want, rtol=RTOL)


def test_seq_parallel_bf16_and_wide_targets(ranks, world, cases):
    b = cases["bf16"]
    mesh = jax_make_mesh((world,), ("seq",), devices=jax.devices("cpu")[:world])
    want = jax.jit(lambda *a: jax_asg_loss_seq(mesh, *a, reduction="none"))(
        jnp.asarray(b["trans"]), jnp.asarray(b["inputs"], jnp.bfloat16),
        jnp.asarray(b["targets"]))
    for r in ranks:
        assert r["bf16"].dtype == np.float32 and np.isfinite(r["bf16"]).all()
        np.testing.assert_allclose(r["bf16"], np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("chunks", [1, 4])
def test_chunk_fold_in_one_process_matches_scan(chunks):
    """The chunk programs and the fold, the all-gather replaced by stacking
    (one process, no group): equal to the JAX scan tier, values and
    gradients."""
    from torch_asg_tpu_torch.parallel.sequence_parallel import (chunk_boundaries,
                                                                loss_from_boundaries)

    c = _case(np.random.default_rng(7), 16, 3, 4, 5, lis=[16, 9, 3], los=[4, 2, 1])
    t = _t(c)
    tr = t["trans"].clone().requires_grad_(True)
    x = t["inputs"].clone().requires_grad_(True)
    per = 16 // chunks
    bounds = [chunk_boundaries(tr, x[p * per:(p + 1) * per], t["targets"], t["li"],
                               t["lo"], p * per, p == 0) for p in range(chunks)]
    got = loss_from_boundaries([b[0] for b in bounds], [b[1] for b in bounds], t["lo"])
    got.sum().backward()
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want, (gt, gi) = jax.jit(jax.value_and_grad(
        lambda a, b: jax_asg_loss(a, b, j["targets"], j["li"], j["lo"], reduction="sum",
                                  impl="scan"), (0, 1)))(j["trans"], j["inputs"])
    np.testing.assert_allclose(got.sum().item(), want, rtol=RTOL)
    np.testing.assert_allclose(tr.grad.numpy(), gt, rtol=RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), gi, rtol=RTOL, atol=GRAD_ATOL)
