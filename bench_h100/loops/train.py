"""Training: a closed loop of the port's ``make_train_step`` steps over a
pool of batches prepared in set-up and resident on the card.

Set-up draws the weights and the pool from the seed, builds the train
state, and drives it through one pass over the pool and one more step;
the first three of those steps are the ones the reference follows.  The
window holds steps alone (no host preparation, no copy to the card) and
ends in one synchronise.  The rate is reported as ``frames_per_s``.
"""

from __future__ import annotations

import torch

from .. import checks, data, harness, weights, work
from . import common

SPAN = "bench.step"


def first_gradients(optimizer, named, beta1: float) -> dict:
    """The gradient each leaf's optimizer took in step one, from AdamW's
    first moment; zeros where the optimizer holds no state."""
    out = {}
    for name, p in named:
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[name] = torch.zeros_like(p.detach()) if m is None else m / (1.0 - beta1)
    return out


def build(cfg: dict, seed: int, device):
    """(weights, model, state, step): the port's train state from the
    benchmark's weights."""
    import torch_asg_tpu_torch.models as models

    w = weights.make(cfg, seed, device)
    model = common.program_model(cfg, w, device)
    opt = cfg["optimizer"]
    state = models.create_train_state(
        model, lambda ps: torch.optim.AdamW(ps, lr=opt["lr"], betas=tuple(opt["betas"]),
                                            eps=opt["eps"], weight_decay=opt["weight_decay"]))
    return w, model, state, models.make_train_step(model, state.optimizer)


def warm_up(cfg, w, model, state, step, pool) -> tuple:
    """The first pass over the pool and one more step; returns (state, the
    program's readings of its first three steps)."""
    named = [*model.named_parameters(), ("transition", state.transition)]
    losses = []
    for i in range(3):
        state, loss = step(state, pool[i % len(pool)])
        losses.append(loss)
        if i == 0:
            grads = checks.norms(first_gradients(state.optimizer, named,
                                                 cfg["optimizer"]["betas"][0]))
    change = checks.norms({n: p.detach() - w[n] for n, p in named})
    prog = {"loss": [float(x) for x in losses], "grad": grads, "change": change}
    for i in [*range(3, len(pool)), 0]:
        state, loss = step(state, pool[i])
    return state, prog


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
    want = checks.reference_train(cfg, trf, cell.seed, dev)
    numbers, leaves = checks.train_numbers(prog, want)
    return harness.Outcome(
        end_to_end={"frames_per_s": k * frames / win.seconds_taken,
                    "peak_mem_gib": harness.peak_gib(peak), "setup_s": setup_s},
        attempted=k, failed=failed, numbers=numbers, memory_peak_bytes=peak, count=1,
        diagnostics={"steps": k, "window_s": win.seconds_taken,
                     "steps_each_second": win.per_second(),
                     "losses_first_three": prog["loss"], "reference_losses": want["loss"],
                     "worst_leaves": leaves,
                     "setup_marks_s": marks.at, "nvidia_smi_open": smi0, "nvidia_smi_close": smi1},
        traces=[win.result] if win.result else [], facts={**facts, "window_s": win.seconds_taken})


def window_work(cfg, trf, pool, steps) -> dict:
    """Work of the window's steps, counted from the batches' shapes."""
    stride, n = cfg["model"]["frontend_stride"], cfg["model"]["num_labels"]
    t_pad = -(-trf["pad_frames"] // stride)
    ops = nbytes = 0.0
    per = []
    for b in pool:
        el = (-(-b["feature_lengths"].cpu() // stride)).tolist()
        per.append(work.criterion_work(n, el, b["target_lengths"].cpu().tolist(), t_pad,
                                       trf["pad_targets"]))
    for k in range(1, steps + 1):
        o, nb = per[k % len(per)]
        ops += o
        nbytes += nb
    enc = work.encoder_flops(cfg["model"], trf["batch"], trf["pad_frames"], train=True)
    return {"steps": steps, "criterion_ops": ops, "criterion_bytes": nbytes,
            "model_flops": enc * steps + ops}
