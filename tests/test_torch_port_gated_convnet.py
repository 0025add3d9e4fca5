"""``GatedConvNet`` (``models/gated_convnet.py``) against the plain reference
``tests/plain_gated_convnet.py`` in float64 on the CPU, at a small size
(4 gated layers of widths 8-16 with kernels 3, 4, 5 and 6, N = 6, B = 2,
T from 1 to 17), on both routes a convolution can take here: ``F.conv1d``
(the CPU's route) and the hand-written kernel's autograd function over its
plain versions (``conv_route`` made to answer ``'kernel'``, as
``test_torch_port_conv.py`` does for ``Wav2Letter``).  Covered: the
emissions, the masks dropout draws, the loss and every gradient (v, g,
bias, transition) of a ``make_train_step`` step with dropout on, and the
parameters after that AdamW step.

Tolerances: both sides compute in float64 with the same operations up to
summation order (the kernel route's unfold-and-product against
``F.conv1d``; ``F.glu`` against a sliced sigmoid; the fused ASG tier
against the oracle's recursions), so they agree to about 1e-13 relative;
1e-10 leaves room for the products of 17 frames' worth of recursions and
is still far below what a wrong pad, mask or norm moves (order 1e-2).
"""

import pytest
import torch

import plain_gated_convnet as plain
import torch_asg_tpu_torch.models.gated_convnet as gc
from torch_asg_tpu_torch.models import GatedConvNet, create_train_state, make_train_step

N, FEATURES, B = 6, 5, 2
CFG = dict(channels=(8, 12, 10, 16), kernels=(3, 4, 5, 6), dropout=(0.2, 0.3, 0.25, 0.35, 0.4),
           hidden=14)
RTOL = ATOL = 1e-10
OPT = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@pytest.fixture(params=["conv1d", "kernel"])
def route(request, monkeypatch):
    calls = []
    if request.param == "kernel":
        real = gc.conv_bias
        monkeypatch.setattr(gc, "conv_route", lambda *a: "kernel")
        monkeypatch.setattr(gc, "conv_bias", lambda *a: calls.append(a[1].shape) or real(*a))
    return request.param, calls


def _model(seed=0):
    torch.manual_seed(seed)
    return GatedConvNet(N, FEATURES, device="cpu", dtype=torch.float64, **CFG)


def _params(model, transition=None):
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if transition is not None:
        out["transition"] = transition.detach().clone()
    return out


def _batch(length, seed=1):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([length, max(1, length - 3)])
    target_lengths = torch.clamp(lengths // 3, min=1)
    return {"features": torch.randn(B, length, FEATURES, generator=g, dtype=torch.float64),
            "feature_lengths": lengths,
            "targets": torch.randint(0, N, (B, int(target_lengths.max())), generator=g),
            "target_lengths": target_lengths}


@pytest.mark.parametrize("length", [1, 4, 9, 17])
def test_emissions_match_the_plain_reference(route, length):
    model = _model()
    feats = _batch(length)["features"]
    got = model(feats)
    want = plain.encoder(_params(model), feats)
    assert got.shape == (length, B, N)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    name, calls = route
    assert len(calls) == (len(CFG["kernels"]) if name == "kernel" else 0)


@pytest.mark.parametrize("length", [6, 17])
def test_dropout_masks_follow_the_shared_rule(route, length):
    """With ``train=True`` the program draws, layer by layer, the masks the
    reference draws from the same generator state."""
    model = _model()
    feats = _batch(length)["features"]
    got = model(feats, train=True, generator=torch.Generator().manual_seed(11))
    keep = plain.masks(torch.Generator().manual_seed(11), _params(model), CFG["dropout"], B,
                       length, "cpu", torch.float64)
    assert len(keep) == len(CFG["dropout"]) and all((~k).any() and k.any() for k in keep)
    want = plain.encoder(_params(model), feats, CFG["dropout"], keep)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, model(feats))


@pytest.mark.parametrize("length", [3, 11, 17])
def test_train_step_loss_gradients_and_adamw_step(route, length):
    """One ``make_train_step`` step with dropout on: its loss, each leaf's
    gradient (v, g, bias of every layer and the transition) and the
    parameters after AdamW, against the reference's."""
    model = _model(seed=length)
    state = create_train_state(model, lambda ps: torch.optim.AdamW(ps, **OPT))
    start = _params(model, state.transition)
    batch = _batch(length, seed=length)
    step = make_train_step(model, state.optimizer, generator=torch.Generator().manual_seed(5))
    state, loss = step(state, batch)
    keep = plain.masks(torch.Generator().manual_seed(5), start, CFG["dropout"], B, length,
                       "cpu", torch.float64)
    want_loss, want_grads = plain.loss_and_grads(start, batch, CFG["dropout"], keep)
    torch.testing.assert_close(loss, want_loss, rtol=RTOL, atol=ATOL)
    named = dict(model.named_parameters()) | {"transition": state.transition}
    assert named.keys() == want_grads.keys()
    leaves = {k.rsplit(".", 1)[-1] for k in named}
    assert leaves == {"weight_v", "weight_g", "bias", "transition"}
    for k, p in named.items():
        torch.testing.assert_close(p.grad, want_grads[k], rtol=RTOL, atol=ATOL, msg=k)
    after = plain.adamw_step(start, want_grads, **OPT)
    for k, p in named.items():
        torch.testing.assert_close(p.detach(), after[k], rtol=RTOL, atol=ATOL, msg=k)
    name, calls = route
    # a forward call a convolution; no second forward for the backward
    assert len(calls) == (len(CFG["kernels"]) if name == "kernel" else 0)


def test_published_defaults():
    model = GatedConvNet(30, device="meta")
    assert [c.weight_v.shape[-1] for c in model.convs] == list(range(13, 30))
    weights = sum(p.numel() for n, p in model.named_parameters() if n.endswith("weight_v"))
    assert weights == 208_828_074
    assert sum(p.numel() for p in model.parameters()) == 208_828_074 + 2 * 17_934
    assert model.dropouts[0] == 0.2 and model.dropouts[-1] == model.dropouts[-2]
    assert model.dropout == pytest.approx(0.2 * 1.07 ** 16)
    assert model.convs[0].weight_v.shape == (400, 40, 13)
    assert model.convs[-1].weight_v.shape == (1816, 826, 29)
    assert model.hidden.weight_v.shape == (1816, 908) and model.out.weight_v.shape == (30, 908)


def test_weight_norm_starts_at_v_and_follows_g():
    model = _model()
    layer = model.convs[1]
    torch.testing.assert_close(layer.weight(), layer.weight_v, rtol=1e-14, atol=1e-14)
    with torch.no_grad():
        layer.weight_g.mul_(2.0)
    torch.testing.assert_close(layer.weight(), 2.0 * layer.weight_v, rtol=1e-14, atol=1e-14)


def test_a_dtensor_weight_is_refused(monkeypatch):
    model = _model()
    monkeypatch.setattr(gc, "DTensor", torch.nn.Parameter)  # every parameter "is" one
    with pytest.raises(ValueError, match="no tensor-parallel forward"):
        model(_batch(4)["features"])


def test_widths_and_rates_must_agree():
    with pytest.raises(ValueError, match="a rate for each convolution"):
        GatedConvNet(N, FEATURES, channels=(8,), kernels=(3,), dropout=(0.1,), device="cpu")
    with pytest.raises(ValueError, match="must be even"):
        GatedConvNet(N, FEATURES, channels=(9,), kernels=(3,), dropout=(0.1, 0.1),
                     device="cpu")
