"""The plain reference agrees with the port's CPU path at a tiny size in
float64: host preparation, encoder, ASG loss and gradients, AdamW, Viterbi
and the collapse."""

import numpy as np
import pytest
import torch

from bench_h100 import data, weights
from bench_h100.reference import model as ref
from bench_h100.reference import prep

from . import tiny

D = torch.float64


@pytest.fixture(scope="module", autouse=True)
def float64_default():
    """float64 as the default dtype for this module's tests alone."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(D)
    yield
    torch.set_default_dtype(old)


def port_model(cfg, w):
    from torch_asg_tpu_torch.models import Wav2Letter

    m = Wav2Letter(**cfg["model"], device="cpu", dtype=D)
    m.load_state_dict({k: v.to(D) for k, v in weights.encoder_state(w).items()})
    return m


@pytest.fixture(scope="module")
def case():
    cell = tiny.cell("letters-train", seed=11)
    cfg, trf = cell.config, cell.traffic
    utts, labels = data.raw_batch(trf, cfg, 11, 0)
    w = weights.make(cfg, 11, "cpu", transition_scale=0.5)
    return cfg, trf, utts, labels, w


def test_host_preparation(case):
    from torch_asg_tpu_torch.runtime import host

    cfg, trf, utts, labels, _ = case
    prog = data.host_prep(utts, labels, cfg, trf)
    feats, fl = prep.pack(utts, trf["pad_frames"])
    np.testing.assert_allclose(prog["features"], feats, rtol=1e-4, atol=1e-4)
    assert np.array_equal(prog["feature_lengths"], fl)
    tg, tl = prep.targets(labels, cfg["alphabet_size"], cfg["max_reps"], trf["pad_targets"])
    assert np.array_equal(prog["targets"], tg) and np.array_equal(prog["target_lengths"], tl)
    rng = np.random.default_rng(0)
    for _ in range(20):
        path = rng.integers(-1, cfg["model"]["num_labels"], size=40)
        assert host.collapse_path(path, cfg["alphabet_size"], cfg["max_reps"]).tolist() == \
            prep.collapse(path, cfg["alphabet_size"], cfg["max_reps"])
    assert prep.encode([3, 3, 3, 3, 5], 28, 2) == [3, 29, 3, 5]


def test_encoder_loss_and_gradients(case):
    import torch_asg_tpu_torch as pt

    cfg, trf, utts, labels, w = case
    feats, fl = prep.pack(utts, trf["pad_frames"])
    tg, tl = prep.targets(labels, cfg["alphabet_size"], cfg["max_reps"], trf["pad_targets"])
    x, fl, tg, tl = (torch.as_tensor(a) for a in (feats, fl, tg, tl))
    model = port_model(cfg, w)
    params = {k: v.to(D).clone().requires_grad_(True) for k, v in w.items()}
    em_ref = ref.encoder(params, x, cfg["model"])
    em = model(x)
    torch.testing.assert_close(em, em_ref, rtol=1e-10, atol=1e-10)
    li = model.output_length(fl)
    trans = params["transition"]
    for impl in ("scan", "fused"):
        mine = ref.asg_loss(trans, em_ref, tg, li, tl).mean()
        t2 = trans.detach().clone().requires_grad_(True)
        e2 = em_ref.detach().clone().requires_grad_(True)
        port = pt.asg_loss(t2, e2, tg.int(), li.int(), tl.int(), impl=impl)
        torch.testing.assert_close(port, mine, rtol=1e-10, atol=1e-9)
        g_ref = torch.autograd.grad(mine, [trans, em_ref], retain_graph=True)
        g_port = torch.autograd.grad(port, [t2, e2])
        for a, b in zip(g_port, g_ref):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    mine = {k: v.clone() for k, v in p0.items()}
    theirs = [v.clone().requires_grad_(True) for v in p0.values()]
    settings = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    opt, topt = ref.AdamW(mine, **settings), torch.optim.AdamW(theirs, **settings)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p0.items()}
        for p, gr in zip(theirs, grads.values()):
            p.grad = gr.clone()
        opt.step(grads)
        topt.step()
    for a, b in zip(mine.values(), theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-12, atol=1e-14)


def test_viterbi(case):
    import torch_asg_tpu_torch as pt

    cfg, trf, utts, _, w = case
    feats, fl = prep.pack(utts, trf["pad_frames"])
    x, fl = torch.as_tensor(feats), torch.as_tensor(fl)
    params = {k: v.to(D) for k, v in w.items()}
    with torch.no_grad():
        em = ref.encoder(params, x, cfg["model"])
    li = ref.output_length(fl, cfg["model"]["frontend_stride"])
    dec = pt.viterbi_decode(params["transition"], em, li.int())
    best = ref.viterbi_best(params["transition"], em, li)
    torch.testing.assert_close(dec.scores, best, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(ref.path_score(params["transition"], em, li, dec.paths),
                               best, rtol=1e-12, atol=1e-9)
    scores, paths = ref.viterbi_decode(params["transition"], em, li)
    assert torch.equal(paths, dec.paths)
    torch.testing.assert_close(scores, best)
