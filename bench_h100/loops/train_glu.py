"""Training the gated ConvNet (``configs/conv-glu-librispeech.json``): a
closed loop of the port's ``make_train_step`` steps over a pool of batches
prepared in set-up and resident on the card, as ``loops/train.py`` runs
Wav2Letter, with dropout on.

Set-up draws the weights (``weights_glu.py``) and the pool from the seed,
builds the train state, seeds the step's dropout generator from the seed
(its own stream, ``DROPOUT``), and drives the state through one pass over
the pool and one more step; the first three of those steps are the ones
the reference (``reference/gated_convnet.py``, float64, in blocks of
its ``ROWS`` rows) follows, drawing the same masks.  The window holds
steps alone and ends in one synchronise; the rate is ``frames_per_s``.

Importing the module registers its control and faults in
``faults.BY_LOOP['train_glu']``: ``control`` (the reference in float32
with TF32 on, in the program's place, drawing the program's masks),
``unchanged_state`` and ``half_batch`` (``faults.py``'s own).  Readings
take them through ``readings.py`` with this module imported first:

    python3 -c "import sys, bench_h100.loops.train_glu; from bench_h100 import readings; \\
        sys.exit(readings.main())" --workload conv-glu-train --seeds 1,2,3 ...
"""

from __future__ import annotations

import time

import torch

from .. import checks, data, faults, harness, seeds, weights_glu, work, work_glu
from ..reference import gated_convnet as glu_ref
from ..reference import model as ref
from . import common
from .train import SPAN, warm_up

DROPOUT = 4  # the seed's stream for the step's dropout masks (seeds.py has 1-3)


def dropout_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, DROPOUT))
    return gen


def program_model(config: dict, w: dict, device):
    """The port's ``GatedConvNet`` at the configuration's widths, holding
    the benchmark's weights."""
    from torch_asg_tpu_torch.models import GatedConvNet

    m = config["model"]
    model = GatedConvNet(m["num_labels"], m["in_features"], m["channels"], m["kernels"],
                         m["dropout"], m["hidden"], device=device,
                         dtype=getattr(torch, config["dtype"]))
    model.load_state_dict(weights_glu.encoder_state(w))
    return model


def build(cfg: dict, seed: int, device):
    """(weights, model, state, step): the port's train state from the
    benchmark's weights, its step drawing dropout from the seed."""
    import torch_asg_tpu_torch.models as models

    w = weights_glu.make(cfg, seed, device)
    model = program_model(cfg, w, device)
    opt = cfg["optimizer"]
    state = models.create_train_state(
        model, lambda ps: torch.optim.AdamW(ps, lr=opt["lr"], betas=tuple(opt["betas"]),
                                            eps=opt["eps"], weight_decay=opt["weight_decay"]))
    step = models.make_train_step(model, state.optimizer,
                                  generator=dropout_generator(seed, device))
    return w, model, state, step


def reference_train(cfg: dict, trf: dict, seed: int, device) -> dict:
    """The reference's first three steps from the benchmark's weights, each
    on the batch of that index with the masks of that step."""
    dtype = torch.float64
    w = weights_glu.make(cfg, seed, device)
    params = {k: v.to(dtype) for k, v in w.items()}
    del w
    start = {k: v.clone() for k, v in params.items()}
    opt = ref.AdamW(params, **cfg["optimizer"])
    gen = dropout_generator(seed, device)
    rates = cfg["model"]["dropout"]
    out = {"loss": []}
    for i in range(3):
        batch = checks.ref_batch(cfg, trf, seed, i, device, dtype)
        keep = glu_ref.masks(gen, params, rates, batch[0].shape[0], trf["pad_frames"], device)
        loss, grads = glu_ref.loss_and_grads(params, batch, rates, keep)
        del keep
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = checks.norms(grads)
        opt.step(grads)
        del grads
    out["change"] = checks.norms({k: params[k] - start[k] for k in params})
    return out


def run(cell) -> harness.Outcome:
    cfg, trf, dev = cell.config, cell.traffic, cell.device
    marks = common.Marks(cell)
    common.reset_peak(dev)
    w, model, state, step = build(cfg, cell.seed, dev)
    marks("model")
    pool = data.pool(trf, cfg, cell.seed, dev)
    marks("pool")
    frames = data.emission_frames(trf, cfg)
    state, prog = warm_up(cfg, w, model, state, step, pool)
    del w
    marks("warm")
    smi0 = harness.smi()
    setup_s = harness.setup_done(cell)
    taken = []
    with common.Window(dev, cell.seconds, cell.trace) as win:
        k = 0
        while True:
            k += 1
            with torch.profiler.record_function(SPAN):
                state, loss = step(state, pool[k % len(pool)])
            taken.append(loss)
            if win.tick():
                break
    smi1 = harness.smi()
    peak = common.peak(dev)
    failed = int((~torch.isfinite(torch.stack(taken))).sum())
    facts = window_work(cfg, trf, pool, k)
    del state, step, model, pool, taken
    common.free(dev)
    t0 = time.perf_counter()
    want = reference_train(cfg, trf, cell.seed, dev)
    reference_s = time.perf_counter() - t0
    numbers, leaves = checks.train_numbers(prog, want)
    return harness.Outcome(
        end_to_end={"frames_per_s": k * frames / win.seconds_taken,
                    "peak_mem_gib": harness.peak_gib(peak), "setup_s": setup_s},
        attempted=k, failed=failed, numbers=numbers, memory_peak_bytes=peak, count=1,
        diagnostics={"steps": k, "window_s": win.seconds_taken,
                     "steps_each_second": win.per_second(),
                     "losses_first_three": prog["loss"], "reference_losses": want["loss"],
                     "worst_leaves": leaves, "setup_marks_s": marks.at,
                     "reference_s": reference_s,
                     "nvidia_smi_open": smi0, "nvidia_smi_close": smi1},
        traces=[win.result] if win.result else [], facts={**facts, "window_s": win.seconds_taken})


def window_work(cfg, trf, pool, steps) -> dict:
    """Work of the window's steps, counted from the batches' shapes: the
    criterion's (``work.criterion_work``), the convolutions' and the whole
    encoder's (``work_glu``)."""
    model, t_pad = cfg["model"], trf["pad_frames"]
    per = [work.criterion_work(model["num_labels"], b["feature_lengths"].cpu().tolist(),
                               b["target_lengths"].cpu().tolist(), t_pad, trf["pad_targets"])
           for b in pool]
    ops = sum(per[k % len(per)][0] for k in range(1, steps + 1))
    nbytes = sum(per[k % len(per)][1] for k in range(1, steps + 1))
    conv_ops, conv_bytes = work_glu.conv_work(model, trf["batch"], t_pad)
    enc = work_glu.encoder_flops(model, trf["batch"], t_pad)
    return {"steps": steps, "criterion_ops": ops, "criterion_bytes": nbytes,
            "conv_ops": conv_ops * steps, "conv_bytes": conv_bytes * steps,
            "model_flops": enc * steps + ops}


# --- the control and the faults of this loop ----------------------------------


def control():
    """The reference, float32 with TF32 on (on the CPU, every product's
    operands rounded to TF32), in the program's place: its loss and
    gradient step the program's parameters through the same AdamW, with
    the masks the program's step would draw."""
    import torch_asg_tpu_torch.models as models

    def make(model, optimizer, *a, generator=None, **k):
        rates = model.dropouts

        def body(state, batch):
            optimizer.zero_grad(set_to_none=True)
            params = dict(model.named_parameters())
            feats = batch["features"]
            keep = glu_ref.masks(generator, params, rates, feats.shape[0], feats.shape[1],
                                 feats.device)
            with faults._tf32(feats.device) as rnd:
                em = glu_ref.encoder(params, feats, rates, keep, round_tf32=rnd)
                loss = ref.asg_loss(state.transition, em, batch["targets"],
                                    batch["feature_lengths"], batch["target_lengths"],
                                    round_tf32=rnd).mean()
                loss.backward()
            optimizer.step()
            state.step += 1
            return state, loss.detach()

        return body

    return faults.patched(models, "make_train_step", make)


faults.BY_LOOP.setdefault("train_glu", {"control": control,
                                        "unchanged_state": faults.unchanged_state,
                                        "half_batch": faults.half_batch})
