"""The port's own spans (``utils/profiling.py``): ``span`` is one shared
no-op without a profiler, and a step then adds nothing to the autograd
graph; under a CPU profiler one ``make_train_step`` step records every
``asg.*`` span once, nested in time as the module's table says, with each
stage's convolutions, forward and backward, inside that stage's spans; the
spans change no bit of the loss or of any gradient, on the plain and the
tensor-parallel step; the data-parallel step all-reduces its gradients
inside ``asg.grad_allreduce``; the criterion, the decoder and the collapse
record theirs on every tier; a ``GatedConvNet`` step records its
weight-norm, gated and head spans with their backwards and an
``asg.conv`` a convolution on the kernel's route."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_asg_tpu_torch.models.gated_convnet as gc
from torch_asg_tpu_torch import asg_scores, viterbi_decode
from torch_asg_tpu_torch.models import (GatedConvNet, Wav2Letter, create_train_state, loss_fn,
                                        make_train_step, shard_train_state)
from torch_asg_tpu_torch.parallel.launch import spawn_ranks
from torch_asg_tpu_torch.runtime import collapse_path
from torch_asg_tpu_torch.utils import profiling

CFG = dict(num_labels=8, in_features=6, channels=8, head_channels=12,
           frontend_kernel=5, kernel=3)
STAGES = ("frontend", "mid", "wide")
SPAWN_TIMEOUT_S = 300


def _model(depth=2, dropout=0.0, dtype=torch.float32):
    torch.manual_seed(0)
    return Wav2Letter(depth=depth, dropout=dropout, device="cpu", dtype=dtype, **CFG)


def _batch(dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    return {"features": torch.randn(4, 20, CFG["in_features"], generator=g, dtype=dtype),
            "feature_lengths": torch.tensor([20, 15, 11, 18]),
            "targets": torch.randint(0, CFG["num_labels"], (4, 4), generator=g),
            "target_lengths": torch.tensor([4, 3, 2, 4])}


def _spans(prof) -> dict:
    """{name: [(start, end, thread)]} of the ``asg.*`` spans and the
    convolutions a profile recorded, in time order."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("asg.") or name in ("aten::convolution",
                                               "aten::convolution_backward"):
            out.setdefault(name, []).append((e.start_ns(), e.end_ns(), e.start_thread_id()))
    return {k: sorted(v) for k, v in out.items()}


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner[2] == outer[2]


def _step_profile(depth=2):
    model = _model(depth)
    state = create_train_state(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        make_train_step(model, state.optimizer)(state, _batch())
    return _spans(prof)


def _graph_nodes(loss) -> int:
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo.extend(n for n, _ in node.next_functions)
    return len(seen)


def test_span_is_one_shared_noop_without_a_profiler():
    assert profiling.span("asg.a") is profiling.span("asg.b") is profiling._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("asg.a")
    assert isinstance(on, profiling._RecordFunctionFast)


def test_a_step_without_a_profiler_adds_nothing_to_the_graph(monkeypatch):
    model = _model()
    state = create_train_state(model)
    off = _graph_nodes(loss_fn(model, state, _batch()))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _graph_nodes(loss_fn(model, state, _batch()))
    # an open and a close for mid and wide; the front end's open alone
    # (its close is a hook on a node the step has anyway)
    assert on == off + 5

    def refuse(*a, **k):
        raise AssertionError("a span was attached with no profiler running")

    monkeypatch.setattr(profiling._OnBackward, "apply", refuse)
    monkeypatch.setattr(profiling, "_last_node", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    make_train_step(model, state.optimizer)(state, _batch())


@pytest.mark.parametrize("depth", [2, 0])
def test_a_train_step_records_every_span_nested(depth):
    spans = _step_profile(depth)
    stages = [s for s in STAGES if depth or s != "mid"]
    names = {"asg.encoder", "asg.criterion", "asg.host_sync"}
    names |= {f"asg.encoder.{s}{b}" for s in stages for b in ("", ".backward")}
    assert {k for k in spans if k.startswith("asg.")} == names
    assert all(len(spans[k]) == 1 for k in names)
    (enc,), (crit,) = spans["asg.encoder"], spans["asg.criterion"]
    (sync,) = spans["asg.host_sync"]
    fwd = [spans[f"asg.encoder.{s}"][0] for s in stages]
    bwd = [spans[f"asg.encoder.{s}.backward"][0] for s in reversed(stages)]
    assert all(_within(f, enc) for f in fwd)
    assert _within(sync, crit) and enc[1] <= crit[0] and crit[1] <= bwd[0][0]
    order = fwd + bwd  # the stages one after another, then back
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("stage,count", [("frontend", 1), ("mid", 2), ("wide", 1)])
def test_each_convolution_falls_inside_its_stage(stage, count):
    spans = _step_profile()
    for op, suffix in (("aten::convolution", ""), ("aten::convolution_backward", ".backward")):
        (outer,) = spans[f"asg.encoder.{stage}{suffix}"]
        assert sum(_within(c, outer) for c in spans[op]) == count
        assert len(spans[op]) == 4


@pytest.mark.parametrize("depth,dropout", [(2, 0.0), (0, 0.0), (2, 0.25)])
def test_spans_change_no_bit_of_loss_or_gradient(depth, dropout):
    got = []
    for traced in (False, True):
        model = _model(depth, dropout)
        state = create_train_state(model)
        gen = torch.Generator().manual_seed(3)
        state.optimizer.zero_grad(set_to_none=True)
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            loss = loss_fn(model, state, _batch(), train=dropout > 0, generator=gen)
            loss.backward()
        named = [*model.named_parameters(), ("transition", state.transition)]
        got.append((loss.detach(), {n: p.grad.clone() for n, p in named}))
    (l0, g0), (l1, g1) = got
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


@pytest.mark.parametrize("impl,validate,syncs", [
    ("fused", True, 1), ("pallas", True, 1), ("matmul", True, 1), ("scan", True, 0),
    ("auto", False, 0)])
def test_criterion_span_on_every_tier(impl, validate, syncs):
    g = torch.Generator().manual_seed(2)
    transition = torch.randn(5, 5, generator=g)
    em = torch.randn(9, 2, 5, generator=g)
    targets = torch.randint(0, 5, (2, 3), generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        asg_scores(transition, em, targets, impl=impl, validate=validate)
    spans = _spans(prof)
    (crit,) = spans["asg.criterion"]
    assert len(spans.get("asg.host_sync", [])) == syncs
    assert all(_within(s, crit) for s in spans.get("asg.host_sync", []))


@pytest.mark.parametrize("what,want", [
    ("decode", {"asg.decode": 1}),
    ("collapse_64_arrays", {"asg.collapse": 64}),
    ("collapse_a_tensor", {"asg.collapse": 1, "asg.host_sync": 1})])
def test_decoder_and_collapse_spans(what, want):
    g = torch.Generator().manual_seed(4)
    em = torch.randn(12, 3, 6, generator=g)
    paths = np.random.default_rng(4).integers(-1, 6, size=(12, 64)).astype(np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if what == "decode":
            viterbi_decode(torch.randn(6, 6, generator=g), em)
        elif what == "collapse_64_arrays":
            for b in range(64):
                collapse_path(paths[:, b], 4, 2)
        else:
            collapse_path(torch.from_numpy(paths[:, 0]), 4, 2)
    spans = _spans(prof)
    assert {k: len(v) for k, v in spans.items() if k.startswith("asg.")} == want
    for sync in spans.get("asg.host_sync", []):
        assert _within(sync, spans["asg.collapse"][0])


def tp_spans(rank, world):
    """On one rank of a (1, 2) mesh: the loss and gradients of one
    tensor-parallel forward and backward with the profiler off and on, and
    of the second the spans recorded and, for each stage, the convolution
    backwards inside its backward span."""
    torch.set_num_threads(1)
    from torch_asg_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    out = {"runs": []}
    for traced in (False, True):
        model = _model(dtype=torch.float64)
        state = shard_train_state(mesh, model, create_train_state(model))
        prof = profile(activities=[ProfilerActivity.CPU])
        with prof if traced else contextlib.nullcontext():
            loss = loss_fn(model, state, _batch(torch.float64))
            loss.backward()
        named = [*model.named_parameters(), ("transition", state.transition)]
        out["runs"].append((float(loss),
                            {n: p.grad.to_local().numpy().copy() for n, p in named}))
    spans = _spans(prof)
    out["names"] = sorted(k for k in spans if k.startswith("asg.encoder"))
    out["backward_convs"] = [
        sum(_within(c, spans[f"asg.encoder.{s}.backward"][0])
            for c in spans["aten::convolution_backward"]) for s in STAGES]
    return out


def test_tensor_parallel_step_records_the_same_stage_spans():
    for out in spawn_ranks(tp_spans, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S):
        (l0, g0), (l1, g1) = out["runs"]
        assert l0 == l1 and g0.keys() == g1.keys()
        assert all(np.array_equal(g0[n], g1[n]) for n in g0)
        assert out["names"] == sorted({"asg.encoder"} | {
            f"asg.encoder.{s}{b}" for s in STAGES for b in ("", ".backward")})
        assert out["backward_convs"] == [1, 2, 1]


def dp_allreduce_spans(rank, world):
    """On one rank of a (2, 1) mesh: one data-parallel train step under the
    profiler; its ``asg.grad_allreduce`` spans, the gradient all-reduces
    inside the first, and the encoder's parameter count."""
    torch.set_num_threads(1)
    from torch_asg_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    model = _model(dtype=torch.float64)
    state = shard_train_state(mesh, model, create_train_state(model))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        make_train_step(model, state.optimizer)(state, _batch(torch.float64))
    spans = _spans(prof).get("asg.grad_allreduce", [])
    reduces = [(e.start_ns(), e.end_ns(), e.start_thread_id())
               for e in prof.profiler.kineto_results.events() if e.name() == "c10d::allreduce_"]
    return {"spans": len(spans), "params": len(list(model.parameters())),
            "inside": sum(_within(r, spans[0]) for r in reduces) if spans else 0}


def test_data_parallel_step_records_its_gradient_allreduce():
    for out in spawn_ranks(dp_allreduce_spans, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S):
        assert out["spans"] == 1
        assert out["inside"] == out["params"]


def test_the_chrome_trace_holds_the_spans(tmp_path):
    model = _model()
    with profiling.trace(str(tmp_path)):
        model(_batch()["features"])
    (written,) = tmp_path.iterdir()
    text = written.read_text()
    assert all(f'"asg.encoder{s}"' in text for s in ("", ".frontend", ".mid", ".wide"))


GATED = dict(channels=(8, 12, 10), kernels=(3, 4, 5), dropout=(0.2, 0.3, 0.25, 0.35), hidden=14)
GATED_STRETCHES = ("asg.weight_norm", "asg.encoder.gated", "asg.encoder.head")
# a gated convolution's backward: the kernel route's autograd function, or F.conv1d's
CONV_BACKWARDS = ("_ConvBiasBackward", "aten::convolution_backward")


def _gated(route, monkeypatch, dropout=True):
    if route == "kernel":
        monkeypatch.setattr(gc, "conv_route", lambda *a: "kernel")
    torch.manual_seed(0)
    cfg = GATED if dropout else {**GATED, "dropout": (0.0,) * 4}
    return GatedConvNet(CFG["num_labels"], CFG["in_features"], device="cpu", **cfg)


def _gated_spans(prof) -> dict:
    """``_spans`` and the gated convolutions' backwards."""
    out = _spans(prof)
    for e in prof.profiler.kineto_results.events():
        if e.name() in CONV_BACKWARDS:
            out.setdefault("conv_backward", []).append(
                (e.start_ns(), e.end_ns(), e.start_thread_id()))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("route,convs", [("conv1d", 0), ("kernel", 3)])
def test_a_gated_step_records_its_spans(route, convs, monkeypatch):
    model = _gated(route, monkeypatch)
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer, generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch())
    spans = _gated_spans(prof)
    names = {"asg.encoder", "asg.criterion", "asg.host_sync"}
    names |= {f"{s}{b}" for s in GATED_STRETCHES for b in ("", ".backward")}
    names |= {"asg.conv"} if convs else set()
    assert {k for k in spans if k.startswith("asg.")} == names
    assert len(spans.get("asg.conv", [])) == convs
    assert all(len(spans[k]) == 1 for k in names - {"asg.conv"})
    (enc,) = spans["asg.encoder"]
    fwd = [spans[s][0] for s in GATED_STRETCHES]
    bwd = [spans[f"{s}.backward"][0] for s in reversed(GATED_STRETCHES)]
    assert all(_within(f, enc) for f in fwd)
    order = fwd + bwd  # weights, convolutions, head; then head, convolutions, weights
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    assert all(_within(c, spans["asg.encoder.gated"][0]) for c in spans.get("asg.conv", []))
    (gated_bwd,) = spans["asg.encoder.gated.backward"]
    assert len(spans["conv_backward"]) == 3
    assert all(_within(c, gated_bwd) for c in spans["conv_backward"])


@pytest.mark.parametrize("route", ["conv1d", "kernel"])
def test_a_gated_step_without_a_profiler_adds_nothing(route, monkeypatch):
    model = _gated(route, monkeypatch, dropout=False)
    state = create_train_state(model)
    off = _graph_nodes(loss_fn(model, state, _batch()))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _graph_nodes(loss_fn(model, state, _batch()))
    # the weights: an open a weight (5) and a close hook; gated: an open and a
    # close hook; head: a close and an open
    assert on == off + 8

    def refuse(*a, **k):
        raise AssertionError("a span was attached with no profiler running")

    monkeypatch.setattr(profiling._OnBackward, "apply", refuse)
    monkeypatch.setattr(profiling, "_last_node", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    make_train_step(model, state.optimizer)(state, _batch())


@pytest.mark.parametrize("route", ["conv1d", "kernel"])
def test_gated_spans_change_no_bit(route, monkeypatch):
    got = []
    for traced in (False, True):
        model = _gated(route, monkeypatch)
        state = create_train_state(model)
        state.optimizer.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(3)
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            loss = loss_fn(model, state, _batch(), train=True, generator=gen)
            loss.backward()
        named = [*model.named_parameters(), ("transition", state.transition)]
        got.append((loss.detach(), {n: p.grad.clone() for n, p in named}))
    (l0, g0), (l1, g1) = got
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
