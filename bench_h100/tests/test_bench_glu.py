"""The ``conv-glu-train`` cell at a tiny size on the CPU: the loop runs the
port's ``GatedConvNet`` through ``make_train_step`` and comes out correct
against the float64 reference (``reference/gated_convnet.py``), the
control and each fault come out not correct, the blocked reference equals
its whole-batch form, the weights start at their v, and ``work_glu``
counts by hand."""

import copy

import pytest
import torch

from bench_h100 import faults, harness, weights_glu, work_glu
from bench_h100.loops import train_glu
from bench_h100.reference import gated_convnet as glu_ref

MODEL = {"in_features": 6, "channels": [8, 10, 12], "kernels": [3, 4, 5],
         "dropout": [0.2, 0.25, 0.3, 0.35], "hidden": 14}
TRAFFIC = {"pool": 3, "batch": 4, "feature_frames": [20, 40], "pad_frames": 40,
           "units_per_second": 15.0, "pad_targets": 16}


def cell(seed=7, trace=False) -> harness.Cell:
    c = harness.load_cell("conv-glu-train", seed, 0.2, trace)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(MODEL)
    c.traffic = {**c.traffic, **TRAFFIC}
    c.device = torch.device("cpu")
    return c


def test_program_is_correct_at_a_tiny_size(monkeypatch):
    monkeypatch.setattr(glu_ref, "ROWS", 3)  # two blocks of the batch of 4, the last short
    line = harness.run_cell(cell(seed=2 ** 32 + 5))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s"}
    d = line["diagnostics"]
    assert d["losses_first_three"] == pytest.approx(d["reference_losses"], rel=1e-5)


def test_traced_run_reads_no_device_metric_on_the_cpu():
    line = harness.run_cell(cell(trace=True))
    assert line["correct"] and line["metrics"] == {}


@pytest.mark.parametrize("fault", ["control", "unchanged_state", "half_batch"])
def test_fault_is_not_correct(fault):
    c = cell(seed=2 ** 31 + 78)
    with faults.BY_LOOP["train_glu"][fault]():
        line = harness.run_cell(c)
    assert line["correct"] is False, line["checks"]


def test_blocked_reference_equals_the_whole_batch(monkeypatch):
    """``loss_and_grads`` in blocks of rows (three passes) against one
    autograd pass over the whole batch, in float64, with masks on."""
    c = cell()
    w = {k: v.double() for k, v in weights_glu.make(c.config, 3, "cpu").items()}
    w["transition"] = torch.randn(30, 30, dtype=torch.float64) * 0.1
    g = torch.Generator().manual_seed(4)
    b, t = 5, 11
    feats = torch.randn(b, t, MODEL["in_features"], dtype=torch.float64, generator=g)
    fl = torch.tensor([11, 9, 11, 4, 7])
    tl = torch.tensor([3, 2, 4, 1, 2])
    tg = torch.randint(0, 30, (b, 4), generator=g)
    rates = MODEL["dropout"]
    keep = glu_ref.masks(torch.Generator().manual_seed(9), w, rates, b, t, "cpu")
    monkeypatch.setattr(glu_ref, "ROWS", 2)
    loss, grads = glu_ref.loss_and_grads(w, [feats, fl, tg, tl], rates, keep)
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    em = glu_ref.encoder(leaves, feats, rates, keep)
    from bench_h100.reference import model as ref
    whole = ref.asg_loss(leaves["transition"], em, tg, fl, tl).mean()
    want = torch.autograd.grad(whole, list(leaves.values()))
    assert loss == pytest.approx(float(whole.detach()), rel=1e-12)
    for k, d in zip(leaves, want):
        torch.testing.assert_close(grads[k], d, rtol=1e-10, atol=1e-12, msg=k)


def test_weights_start_at_v():
    w = weights_glu.make(cell().config, 5, "cpu")
    for name, shape in weights_glu.shapes(cell().config["model"]).items():
        stem = name[:-len(".weight_v")]
        assert w[name].shape == shape
        torch.testing.assert_close(glu_ref.weight(w, stem), w[name])
    assert not w["transition"].any()


def test_published_config_counts():
    spec = harness.load_cell("conv-glu-train", 1, 1, False)
    model = spec.config["model"]
    shapes = weights_glu.shapes(model)
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 208_828_074
    assert spec.config["reduced"] == [] and model["frontend_stride"] == 1
    # 40.08 TFLOP a step at B = 16, 2000 frames: 6 B T a weight, less layer 1's dgrad
    assert work_glu.encoder_flops(model, 16, 2000) == pytest.approx(40.08e12, rel=1e-3)


def test_work_glu_by_hand():
    model = {"in_features": 2, "channels": [4, 6], "kernels": [3, 2], "hidden": 8,
             "num_labels": 5}
    c1, c2 = 2 * 10 * 4 * 2 * 3, 2 * 10 * 6 * 2 * 2
    lin = 2 * 10 * (8 * 3 + 5 * 4)
    assert work_glu.encoder_flops(model, 2, 5, train=False) == c1 + c2 + lin
    assert work_glu.encoder_flops(model, 2, 5) == 2 * c1 + 3 * c2 + 3 * lin
    ops, nbytes = work_glu.conv_work(model, 2, 5, train=False)
    assert ops == c1 + c2
    assert nbytes == 4 * ((10 * 2 + 24 + 4 + 10 * 4) + (10 * 2 + 24 + 6 + 10 * 6))


GLU_METRICS = ("encoder_gated_ms.glu", "encoder_head_ms.glu", "weight_norm_ms.glu",
               "native_convs.glu", "conv_roofline_pct.glu", "step_mfu.glu")


def test_traced_run_reads_every_glu_metric(monkeypatch):
    """The tiny cell's trace laid on a card, the convolutions on the
    kernel's route (its plain versions): each of the cell's per-layer
    metrics reads a number, 3 convolutions a step."""
    import torch_asg_tpu_torch.models.gated_convnet as gc

    from bench_h100 import trace

    from .test_bench_spans import on_a_card

    cpu_trace = trace.Trace
    monkeypatch.setattr(trace, "Trace", lambda prof: cpu_trace(on_a_card(prof)))
    monkeypatch.setattr(gc, "conv_route", lambda *a: "kernel")
    line = harness.run_cell(cell(trace=True))
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(GLU_METRICS)
    assert got["native_convs.glu"] == 3.0
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("name", GLU_METRICS)
def test_glu_readers_read_none_without_their_spans(name):
    from .test_bench_spans import without_program_spans

    read = harness.reader(name).read
    facts = {"steps": 3, "window_s": 1.0}
    if name.startswith("step_mfu"):
        facts = {"steps": 3}  # no counted work: nothing to read
    for traces in ([], [without_program_spans()]):
        out = harness.Outcome(end_to_end={}, attempted=3, failed=0, numbers={},
                              memory_peak_bytes=0, count=1, diagnostics={}, traces=traces,
                              facts=facts)
        assert read(out) is None
