"""The port's multi-host helpers against the JAX package's.

Mirrors the 10 tests of ``tests/test_distributed.py``.  The single-process
rules (no-op without a coordinator, retries, errors that must propagate)
run in this process with ``torch.distributed.init_process_group``
monkeypatched.  The rest run in spawned gloo ranks on the CPU, one spawn a
layout, each with its own timeout: 2 ranks on one host, and 4 ranks as two
hosts of 2 (``LOCAL_WORLD_SIZE=2``), the twin of the JAX test's two
processes of two devices.  There ``init_distributed`` ->
``make_hybrid_mesh`` -> ``local_batch_slice`` -> ``asg_loss_dp`` with
gradients, and ``asg_loss_vp`` over the hybrid mesh's inner 'model' axis,
must equal the single-process JAX oracle (fp64, rtol 1e-10).  The
launcher itself (``parallel.launch.spawn_ranks``) must fail the call, and
leave no rank running, when a rank raises, hangs past its deadline or
exits without a result.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_asg_tpu_torch.parallel.distributed as d
from torch_asg_tpu import asg_loss as jax_asg_loss
from torch_asg_tpu_torch.parallel import init_distributed, local_batch_slice, make_hybrid_mesh
from torch_asg_tpu_torch.parallel.launch import spawn_ranks

SPAWN_TIMEOUT_S = 300
RTOL = 1e-10
# (world size, ranks a host; None: the ranks' own host names decide)
LAYOUTS = ((2, None), (4, 2))


def _problem():
    rng = np.random.default_rng(20260816)
    # num_labels divisible by the hybrid mesh's model axis (2)
    t_total, num_batches, num_labels, s_total = 8, 4, 6, 3
    return dict(
        transition=rng.normal(size=(num_labels, num_labels)) * 0.5,
        inputs=rng.normal(size=(t_total, num_batches, num_labels)),
        targets=rng.integers(0, num_labels, size=(num_batches, s_total)).astype(np.int32),
        input_lengths=np.asarray([8, 6, 8, 7], np.int32),
        target_lengths=np.asarray([3, 2, 3, 1], np.int32),
    )


def rank_checks(rank, world, local, problem):
    """Every check of this module on one rank; numpy results."""
    torch.set_num_threads(1)
    if local is not None:
        os.environ["LOCAL_WORLD_SIZE"] = str(local)
    from torch_asg_tpu_torch.parallel import asg_loss_dp, asg_loss_vp

    out = {"is_multi": init_distributed(device="cpu"), "world": dist.get_world_size()}
    n_local = d.local_world_size()
    out["n_local"] = n_local
    mesh = make_hybrid_mesh(device="cpu")
    mesh2 = make_hybrid_mesh((2,), ("model",), device="cpu")
    out["mesh"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    out["mesh2"] = (mesh2.mesh_dim_names, mesh2.mesh.tolist())
    try:
        make_hybrid_mesh((n_local + 1,), ("model",), device="cpu")
        out["bad_inner"] = "no error"
    except ValueError as e:
        out["bad_inner"] = str(e)

    # the hybrid mesh runs collectives over both axes
    x = torch.ones((2, 3), dtype=torch.float64)  # this rank's block
    total = x.sum()
    for axis in ("data", "model"):
        dist.all_reduce(total, group=mesh2.get_group(axis))
    out["total"] = total.item()

    # each rank loads only its share of the batch
    t = {k: torch.as_tensor(v) for k, v in problem.items()}
    sl = local_batch_slice(t["inputs"].shape[1])
    out["local_slice"] = (sl.start, sl.stop)
    tr = t["transition"].clone().requires_grad_(True)
    loss = asg_loss_dp(mesh, tr, t["inputs"][:, sl], t["targets"][sl],
                       t["input_lengths"][sl], t["target_lengths"][sl],
                       reduction="mean", impl="scan")
    loss.backward()
    out["dp"] = (loss.item(), tr.grad.numpy())

    # vocabulary-split loss over the inner axis (replicated over 'data')
    m = mesh2.get_local_rank("model")
    n = t["transition"].shape[0] // 2
    rows = slice(m * n, (m + 1) * n)
    tr = t["transition"][rows].clone().requires_grad_(True)
    loss = asg_loss_vp(mesh2, tr, t["inputs"][:, :, rows], t["targets"],
                       t["input_lengths"], t["target_lengths"], reduction="mean",
                       axis="model")
    loss.backward()
    out["vp"] = (loss.item(), tr.grad.numpy(), mesh2.get_local_rank("data"), m)
    return out


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def oracle(problem):
    j = {k: jnp.asarray(v) for k, v in problem.items()}
    return jax.value_and_grad(lambda tr: jax_asg_loss(
        tr, j["inputs"], j["targets"], j["input_lengths"], j["target_lengths"],
        reduction="mean", impl="scan"))(j["transition"])


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=lambda p: f"world{p[0]}-hosts{1 if p[1] is None else p[0] // p[1]}")
def layout(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(layout, problem):
    world, local = layout
    return spawn_ranks(rank_checks, world, (local, problem), device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture
def no_launcher_env(monkeypatch):
    for key in d._ENV:
        monkeypatch.delenv(key, raising=False)


def test_init_distributed_single_host_noop(no_launcher_env):
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_hybrid_mesh_shapes(ranks, layout):
    world, local = layout
    for r in ranks:
        assert r["is_multi"] is True and r["world"] == world
        assert r["n_local"] == (world if local is None else local)
        assert r["mesh"] == (("data",), (world,))
        names, layout2 = r["mesh2"]
        assert names == ("data", "model") and np.asarray(layout2).shape == (world // 2, 2)


def test_hybrid_mesh_rejects_bad_inner(ranks):
    for r in ranks:
        assert "need a divisor of the per-host rank count" in r["bad_inner"]


def test_local_batch_slice(ranks, layout, monkeypatch):
    assert local_batch_slice(16) == slice(0, 16)  # one process
    monkeypatch.setattr(d, "_rank_and_size", lambda: (0, 3))
    with pytest.raises(ValueError, match="divisible"):
        d.local_batch_slice(16)
    world = layout[0]
    per = 4 // world
    assert [r["local_slice"] for r in ranks] == [(i * per, (i + 1) * per)
                                                 for i in range(world)]


def test_hybrid_mesh_runs_collectives(ranks, layout):
    for r in ranks:
        assert r["total"] == 6 * layout[0]


def test_init_distributed_retries_rejoining_worker(monkeypatch):
    """A restarted worker sees a transient RuntimeError from the
    coordinator; init_distributed must retry and succeed."""
    calls = []

    def flaky_init(*args, **kwargs):
        calls.append(kwargs)
        if len(calls) == 1:
            raise RuntimeError("connection to coordinator failed")

    monkeypatch.setattr(d.dist, "init_process_group", flaky_init)
    out = d.init_distributed(coordinator_address="localhost:1234", num_processes=1,
                             process_id=0, retries=3, retry_delay_s=0.0, device="cpu")
    assert len(calls) == 2  # failed once, rejoined on retry
    assert calls[1]["init_method"] == "tcp://localhost:1234"
    assert out is False  # single-process topology after init


def test_init_distributed_exhausted_retries_raise(monkeypatch):
    def always_down(*args, **kwargs):
        raise RuntimeError("connection to coordinator failed")

    monkeypatch.setattr(d.dist, "init_process_group", always_down)
    with pytest.raises(RuntimeError, match="coordinator"):
        d.init_distributed(coordinator_address="localhost:1234", num_processes=2,
                           process_id=1, retries=2, retry_delay_s=0.0, device="cpu")


def test_init_distributed_explicit_args_never_masked(monkeypatch, no_launcher_env):
    """A ValueError with explicit coordinator arguments is a
    misconfiguration and propagates; without them this is a single process."""
    def reject(*args, **kwargs):
        raise ValueError("bad coordinator config")

    monkeypatch.setattr(d.dist, "init_process_group", reject)
    with pytest.raises(ValueError, match="bad coordinator"):
        d.init_distributed(coordinator_address="localhost:9", retries=1, device="cpu")
    assert d.init_distributed(retries=1, device="cpu") is False


def test_hybrid_mesh_rejects_mismatched_inner_lengths():
    with pytest.raises(ValueError, match="same length"):
        make_hybrid_mesh((2, 2), ("model",), device="cpu")


def test_two_process_dp_parity(ranks, layout, oracle):
    """Executed multi-process path: the replicated loss and transition
    gradient of asg_loss_dp (data axis over every rank) and of asg_loss_vp
    (the hybrid mesh's inner model axis) equal the single-process oracle
    on every rank."""
    want_loss, want_grad = oracle
    world = layout[0]
    for r in ranks:
        np.testing.assert_allclose(r["dp"][0], want_loss, rtol=RTOL)
        np.testing.assert_allclose(r["dp"][1], want_grad, rtol=RTOL)
        np.testing.assert_allclose(r["vp"][0], want_loss, rtol=RTOL)
    for row in range(world // 2):  # each data row holds the row blocks in order
        blocks = sorted((r["vp"][3], r["vp"][1]) for r in ranks if r["vp"][2] == row)
        np.testing.assert_allclose(np.concatenate([b for _, b in blocks]), want_grad,
                                   rtol=RTOL)
    # each data row of the hybrid mesh lies within one host
    local = layout[1] or world
    for r in ranks:
        for mesh_row in r["mesh2"][1]:
            assert len({rank // local for rank in mesh_row}) == 1


# --- the launcher's failures: each fails the call and leaves no rank behind --


def _fails_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("rank one fails")
    time.sleep(120)  # would outlive the call if it were not killed


def _hangs(rank, world):
    time.sleep(120)


def _exits_without_a_result(rank, world):
    os._exit(3)


@pytest.mark.parametrize("fn, timeout_s, message", [
    (_fails_on_rank_one, 120, "rank one fails"),
    (_hangs, 3, "still running after 3 s"),
    (_exits_without_a_result, 120, "exited without a result"),
], ids=["raises", "deadline", "exits"])
def test_spawn_ranks_fails_the_call_and_kills_the_rest(fn, timeout_s, message):
    import multiprocessing

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=message):
        spawn_ranks(fn, 2, device="cpu", timeout_s=timeout_s)
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()
