"""Serving: a closed loop of one client sending batch-transcription
requests, each a batch of utterances padded to one shape, from a pool made
in set-up and resident on the card.

A request runs the encoder (eval, no gradient), ``viterbi_decode``, the
paths' copy to the host and ``collapse_path`` an utterance (native arm),
and is timed from its submission to the hypotheses on the host.  Set-up
answers every request of the pool once, then one more.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import checks, data, harness, weights
from . import common

SPAN = "bench.request"


def encode(model, features):
    return model(features)


def decode(transition, emissions, lengths):
    import torch_asg_tpu_torch as pt

    return pt.viterbi_decode(transition, emissions, lengths)


def answer(model, transition, request, cfg):
    """(paths (T', B) int32, scores (B,), hypotheses) of one request."""
    from torch_asg_tpu_torch.runtime import collapse_path

    with torch.no_grad():
        with torch.profiler.record_function("bench.encoder"):
            em = encode(model, request["features"])
            li = model.output_length(request["feature_lengths"]).to(torch.int32)
        with torch.profiler.record_function("bench.decode"):
            dec = decode(transition, em, li)
            common.sync(dec.paths.device)  # so that bench.collapse holds no device wait
        with torch.profiler.record_function("bench.collapse"):
            paths = dec.paths.cpu().numpy()
            scores = dec.scores.cpu().numpy()
            hyps = [collapse_path(paths[:, b], cfg["alphabet_size"], cfg["max_reps"],
                                  use_native=True) for b in range(paths.shape[1])]
    return paths, scores, hyps


def run(cell) -> harness.Outcome:
    cfg, trf, dev = cell.config, cell.traffic, cell.device
    marks = common.Marks(cell)
    common.reset_peak(dev)
    w = weights.make(cfg, cell.seed, dev, transition_scale=trf["transition_scale"])
    model = common.program_model(cfg, w, dev).eval()
    transition = w["transition"]
    marks("model")
    pool = data.pool(trf, cfg, cell.seed, dev)
    marks("pool")
    for i in [*range(len(pool)), 0]:
        answer(model, transition, pool[i], cfg)
    marks("warm")
    smi0 = harness.smi()
    setup_s = harness.setup_done(cell)
    latency, served, failed = [], [], 0
    with common.Window(dev, cell.seconds, cell.trace) as win:
        k = 0
        while True:
            k += 1
            index = k % len(pool)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(SPAN):
                    out = answer(model, transition, pool[index], cfg)
            except RuntimeError as exc:
                failed += 1
                out = exc
            latency.append((time.perf_counter() - t0) * 1e3)
            served.append((index, out))
            if win.tick():
                break
    smi1 = harness.smi()
    peak = common.peak(dev)
    del model, transition, pool, w
    common.free(dev)
    done = [i for i, (_, out) in enumerate(served) if not isinstance(out, Exception)]
    pick = [served[done[j]] for j in checks.sample(cell.seed, len(done), trf["sample_requests"])]
    numbers = checks.serve_numbers(cfg, trf, cell.seed, dev,
                                   [(i, *out) for i, out in pick])
    p95 = statistics.quantiles(latency, n=100, method="inclusive")[94]
    return harness.Outcome(
        end_to_end={"request_p95_ms": p95, "peak_mem_gib": harness.peak_gib(peak),
                    "setup_s": setup_s},
        attempted=k, failed=failed, numbers=numbers, memory_peak_bytes=peak, count=1,
        diagnostics={"requests": k, "request_median_ms": statistics.median(latency),
                     "request_p95_ms": p95, "request_max_ms": max(latency),
                     "window_s": win.seconds_taken, "requests_each_second": win.per_second(),
                     "checked_requests": len(pick),
                     "setup_marks_s": marks.at, "nvidia_smi_open": smi0, "nvidia_smi_close": smi1},
        traces=[win.result] if win.result else [],
        facts={"requests": k, "window_s": win.seconds_taken})
