"""The port's batch- and vocabulary-parallel paths against the JAX package's.

Mirrors the 13 tests of ``tests/test_parallel.py``.  Each world size (2
and 4 ranks) is one spawn of gloo ranks on the CPU
(``parallel.launch.spawn_ranks``, its own timeout) that runs every check of
this module and returns its results; each test holds them against the JAX
function on a JAX mesh of the same size over the virtual CPU devices, from
the same seeded numpy inputs.  Per the per-rank contract
(``torch_asg_tpu_torch/parallel/__init__.py``) a rank's split outputs and
gradients are its blocks of the JAX global arrays, and its replicated ones
the whole arrays.

Tolerances: fp64 values rtol 1e-10; fp64 gradients rtol 1e-10 with an atol
of 1e-13 for entries near zero; paths, positions and labels equal; the
bf16 case runs in float32 on both sides, rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_asg_tpu.ops.viterbi import beam_decode as jax_beam_decode
from torch_asg_tpu.ops.viterbi import viterbi_align as jax_viterbi_align
from torch_asg_tpu.ops.viterbi import viterbi_decode as jax_viterbi_decode
from torch_asg_tpu.parallel import asg_loss_dp as jax_asg_loss_dp
from torch_asg_tpu.parallel import asg_loss_vp as jax_asg_loss_vp
from torch_asg_tpu.parallel import fcc_score_vp as jax_fcc_score_vp
from torch_asg_tpu.parallel import make_mesh as jax_make_mesh
from torch_asg_tpu_torch.parallel.launch import spawn_ranks

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300
RTOL, GRAD_ATOL = 1e-10, 1e-13
BF16_TOL = dict(rtol=1e-5, atol=1e-5)


def _cases():
    r = np.random.default_rng(5)
    T, B, S, N = 12, 8, 4, 16
    case = dict(inputs=r.normal(size=(T, B, N)), trans=r.normal(size=(N, N)) * 0.3,
                targets=r.integers(0, N, size=(B, S)), li=r.integers(S, T + 1, size=(B,)),
                lo=r.integers(1, S + 1, size=(B,)))
    r = np.random.default_rng(20260816)
    # bf16 emissions and S > T: the bf16 values kept as float32 numbers
    bf16 = dict(inputs=torch.tensor(r.normal(size=(6, 2, 8)), dtype=torch.bfloat16)
                .float().numpy(),
                trans=(r.normal(size=(8, 8)) * 0.3).astype(np.float32),
                targets=r.integers(0, 8, size=(2, 10)).astype(np.int32))
    T, B, S, N = 8, 3, 3, 8
    inputs = r.normal(size=(T, B, N))
    inputs[4, 1, :] = -np.inf  # element 1: an unreachable frame
    degenerate = dict(inputs=inputs, trans=r.normal(size=(N, N)) * 0.3,
                      targets=r.integers(0, N, size=(B, S)).astype(np.int32),
                      keep=np.asarray([1.0, 0.0, 1.0]))
    return dict(case=case, bf16=bf16, degenerate=degenerate)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _block(n, size, index):
    per = n // size
    return slice(index * per, (index + 1) * per)


def rank_checks(rank, world, cases):
    """Every check of this module on one rank; numpy results."""
    torch.set_num_threads(1)
    from torch_asg_tpu_torch import parallel as par

    out = {}
    c = {k: _t(v) for k, v in cases["case"].items()}
    mesh = par.make_mesh(device="cpu")
    mesh2 = par.make_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out["mesh"] = (mesh.size(0), tuple(mesh2.mesh.shape), mesh2.mesh_dim_names)
    try:
        par.make_mesh((3,), ("data",), device="cpu")
        out["mesh_bad"] = "no error"
    except ValueError as e:
        out["mesh_bad"] = str(e)

    # data parallel: loss per element and reduced, gradients of the sum
    inp, tgt, li, lo = par.shard_batch(mesh, "data", c["inputs"], c["targets"], c["li"],
                                       c["lo"])
    out["dp"] = {red: par.asg_loss_dp(mesh, c["trans"], inp, tgt, li, lo,
                                      reduction=red).numpy()
                 for red in ("none", "mean", "sum")}
    tr = c["trans"].clone().requires_grad_(True)
    x = inp.clone().requires_grad_(True)
    par.asg_loss_dp(mesh, tr, x, tgt, li, lo, reduction="sum").backward()
    out["dp_grads"] = (tr.grad.numpy(), x.grad.numpy())

    # the decoders on this rank's block; blocks of unequal size raise
    res = par.viterbi_decode_dp(mesh, c["trans"], inp, li)
    out["viterbi"] = (res.scores.numpy(), res.paths.numpy())
    res = par.beam_decode_dp(mesh, c["trans"], inp, li, beam_size=4)
    out["beam"] = (res.scores.numpy(), res.paths.numpy())
    res = par.viterbi_align_dp(mesh, c["trans"], inp, tgt, li, lo)
    out["align"] = (res.scores.numpy(), res.positions.numpy(), res.labels.numpy())
    ragged = np.array_split(np.arange(3), world)[rank]
    try:
        par.viterbi_decode_dp(mesh, c["trans"], c["inputs"][:, ragged], None)
        out["ragged"] = "no error"
    except ValueError as e:
        out["ragged"] = str(e)

    # vocabulary parallel on a 1-D 'model' mesh
    vmesh = par.make_mesh(axis_names=("model",), device="cpu")
    n = c["trans"].shape[0]
    rows = _block(n, world, rank)
    out["vp_fcc"] = par.fcc_score_vp(vmesh, c["trans"][rows], c["inputs"][:, :, rows],
                                     c["li"]).numpy()
    out["vp_none"] = par.asg_loss_vp(vmesh, c["trans"][rows], c["inputs"][:, :, rows],
                                     c["targets"], c["li"], c["lo"],
                                     reduction="none").numpy()
    tr = c["trans"][rows].clone().requires_grad_(True)
    x = c["inputs"][:, :, rows].clone().requires_grad_(True)
    par.asg_loss_vp(vmesh, tr, x, c["targets"], c["li"], c["lo"],
                    reduction="sum").backward()
    out["vp_grads"] = (tr.grad.numpy(), x.grad.numpy())

    # the model axis of a composed (world/2) x 2 mesh
    ax = mesh2.get_local_rank("model")
    rows2 = _block(n, 2, ax)
    out["vp_2d"] = par.asg_loss_vp(mesh2, c["trans"][rows2], c["inputs"][:, :, rows2],
                                   c["targets"], c["li"], c["lo"],
                                   reduction="none").numpy()

    # bf16 emissions and targets wider than T
    b = cases["bf16"]
    rows_b = _block(b["trans"].shape[0], world, rank)
    out["bf16"] = par.asg_loss_vp(
        vmesh, _t(b["trans"])[rows_b], _t(b["inputs"], torch.bfloat16)[:, :, rows_b],
        _t(b["targets"]), reduction="none").numpy()

    # a degenerate element masked out of the objective
    d = {k: _t(v) for k, v in cases["degenerate"].items()}
    rows_d = _block(d["trans"].shape[0], world, rank)
    tr = d["trans"][rows_d].clone().requires_grad_(True)
    x = d["inputs"][:, :, rows_d].clone().requires_grad_(True)
    per = par.asg_loss_vp(vmesh, tr, x, d["targets"], reduction="none")
    loss = torch.where(d["keep"] > 0, per, torch.zeros_like(per)).sum()
    loss.backward()
    out["degenerate"] = (loss.item(), tr.grad.numpy(), x.grad.numpy())

    # unknown reductions
    out["bad_reduction"] = []
    for fn, m, args in ((par.asg_loss_vp, vmesh, (c["trans"][rows], c["inputs"][:, :, rows])),
                        (par.asg_loss_dp, mesh, (c["trans"], inp))):
        try:
            fn(m, *args, c["targets"] if fn is par.asg_loss_vp else tgt,
               reduction="avg")
            out["bad_reduction"].append("no error")
        except ValueError as e:
            out["bad_reduction"].append(str(e))
    return out


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(world, cases):
    """Every rank's results for this world size (one spawn each)."""
    return spawn_ranks(rank_checks, world, (cases,), device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S)


def _jmesh(world, name):
    return jax_make_mesh((world,), (name,), devices=jax.devices("cpu")[:world])


def _j(case):
    return {k: jnp.asarray(v) for k, v in case.items()}


def _jit(fn, *args):
    """The JAX function, jitted (an eager shard_map call compiles anew on
    every call)."""
    return jax.jit(fn)(*args)


def _close(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


def test_mesh_helper(ranks, world):
    for r in ranks:
        assert r["mesh"] == (world, (world // 2, 2), ("data", "model"))
        assert "need 3 ranks" in r["mesh_bad"]


def test_dp_matches_single_chip(ranks, world, cases):
    j = _j(cases["case"])
    mesh = _jmesh(world, "data")
    for red in ("none", "mean", "sum"):
        want = _jit(lambda *a: jax_asg_loss_dp(mesh, *a, reduction=red), j["trans"],
                    j["inputs"], j["targets"], j["li"], j["lo"])
        if red == "none":
            _close(np.concatenate([r["dp"]["none"] for r in ranks]), want)
        else:
            for r in ranks:  # replicated: the whole value on every rank
                _close(r["dp"][red], want)


def test_dp_grads_psum(ranks, world, cases):
    j = _j(cases["case"])
    mesh = _jmesh(world, "data")
    gt, gi = _jit(jax.grad(
        lambda tr, x: jax_asg_loss_dp(mesh, tr, x, j["targets"], j["li"], j["lo"],
                                      reduction="sum"), argnums=(0, 1)), j["trans"],
        j["inputs"])
    for r in ranks:  # the whole transition gradient on every rank, not P times it
        _close(r["dp_grads"][0], gt, GRAD_ATOL)
    _close(np.concatenate([r["dp_grads"][1] for r in ranks], axis=1), gi, GRAD_ATOL)


def test_dp_viterbi_decode_matches_single_chip(ranks, world, cases):
    j = _j(cases["case"])
    want = _jit(jax_viterbi_decode, j["trans"], j["inputs"], j["li"])
    _close(np.concatenate([r["viterbi"][0] for r in ranks]), want.scores)
    np.testing.assert_array_equal(np.concatenate([r["viterbi"][1] for r in ranks], axis=1),
                                  np.asarray(want.paths))
    for r in ranks:
        assert f"batch 3 not divisible by mesh axis 'data' = {world}" in r["ragged"]


def test_dp_beam_decode_matches_single_chip(ranks, cases):
    j = _j(cases["case"])
    want = _jit(lambda *a: jax_beam_decode(*a, beam_size=4), j["trans"], j["inputs"],
                j["li"])
    _close(np.concatenate([r["beam"][0] for r in ranks]), want.scores)
    np.testing.assert_array_equal(np.concatenate([r["beam"][1] for r in ranks], axis=1),
                                  np.asarray(want.paths))


def test_dp_viterbi_align_matches_single_chip(ranks, cases):
    j = _j(cases["case"])
    want = _jit(jax_viterbi_align, j["trans"], j["inputs"], j["targets"], j["li"],
                j["lo"])
    _close(np.concatenate([r["align"][0] for r in ranks]), want.scores)
    for i, field in ((1, want.positions), (2, want.labels)):
        np.testing.assert_array_equal(
            np.concatenate([r["align"][i] for r in ranks], axis=1), np.asarray(field))


def test_vp_fcc_forward(ranks, world, cases):
    j = _j(cases["case"])
    mesh = _jmesh(world, "model")
    want = _jit(lambda *a: jax_fcc_score_vp(mesh, *a), j["trans"], j["inputs"], j["li"])
    for r in ranks:
        _close(r["vp_fcc"], want)


def test_vp_asg_loss_and_grads(ranks, world, cases):
    j = _j(cases["case"])
    mesh = _jmesh(world, "model")
    want = _jit(lambda *a: jax_asg_loss_vp(mesh, *a, reduction="none"), j["trans"],
                j["inputs"], j["targets"], j["li"], j["lo"])
    for r in ranks:
        _close(r["vp_none"], want)
    gt, gi = _jit(jax.grad(
        lambda tr, x: jax_asg_loss_vp(mesh, tr, x, j["targets"], j["li"], j["lo"],
                                      reduction="sum"), argnums=(0, 1)), j["trans"],
        j["inputs"])
    _close(np.concatenate([r["vp_grads"][0] for r in ranks]), gt, GRAD_ATOL)
    _close(np.concatenate([r["vp_grads"][1] for r in ranks], axis=2), gi, GRAD_ATOL)


def test_vp_on_2d_mesh(ranks, world, cases):
    j = _j(cases["case"])
    mesh = jax_make_mesh((world // 2, 2), ("data", "model"),
                         devices=jax.devices("cpu")[:world])
    want = _jit(lambda *a: jax_asg_loss_vp(mesh, *a, reduction="none"), j["trans"],
                j["inputs"], j["targets"], j["li"], j["lo"])
    for r in ranks:
        _close(r["vp_2d"], want)


def test_vp_accepts_bf16_and_wide_targets(ranks, world, cases):
    b = cases["bf16"]
    mesh = _jmesh(world, "model")
    want = _jit(lambda *a: jax_asg_loss_vp(mesh, *a, reduction="none"),
                jnp.asarray(b["trans"]), jnp.asarray(b["inputs"], jnp.bfloat16),
                jnp.asarray(b["targets"]))
    for r in ranks:
        assert r["bf16"].dtype == np.float32 and np.isfinite(r["bf16"]).all()
        np.testing.assert_allclose(r["bf16"], np.asarray(want, np.float32), **BF16_TOL)


def test_vp_degenerate_element_does_not_nan_shared_grads(ranks, world, cases):
    d = _j(cases["degenerate"])
    mesh = _jmesh(world, "model")

    def masked(tr, x):
        per = jax_asg_loss_vp(mesh, tr, x, d["targets"], reduction="none")
        return jnp.sum(jnp.where(d["keep"] > 0, per, 0.0))

    loss, (gt, gi) = _jit(jax.value_and_grad(masked, argnums=(0, 1)), d["trans"],
                          d["inputs"])
    got_gt = np.concatenate([r["degenerate"][1] for r in ranks])
    got_gi = np.concatenate([r["degenerate"][2] for r in ranks], axis=2)
    for r in ranks:
        assert np.isfinite(r["degenerate"][0])
        _close(r["degenerate"][0], loss)
    assert np.isfinite(got_gt).all()
    _close(got_gt, gt, GRAD_ATOL)
    for b in (0, 2):  # the kept elements
        assert np.isfinite(got_gi[:, b]).all()
        _close(got_gi[:, b], np.asarray(gi)[:, b], GRAD_ATOL)


def test_vp_unknown_reduction_raises(ranks):
    for r in ranks:
        assert "unknown reduction 'avg'" in r["bad_reduction"][0]


def test_dp_unknown_reduction_raises(ranks):
    for r in ranks:
        assert "unknown reduction 'avg'" in r["bad_reduction"][1]
