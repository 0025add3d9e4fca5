#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, wordpiece-training,
forced-alignment, per-lattice training, posterior-decoding, n-best/beam,
streaming, acceptor-scoring and multi-GPU paths on the CUDA cards (one rank
per card; every other phase on card 0), with the native host library, and
check and time each hand-written kernel against its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises, so the exit code
is nonzero.  Each profile (PROFILES: device busy time, idle share, a warp
route's kernels by device time) is one call taken in a new process of its
own, ``python3 chip_smoke.py --profile NAME``, on inputs of the phase's
shape, and taken again if it lacks one of the port's kernels the call
launches:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from ``torch_asg_tpu_torch/ops/kernels/csrc``,
     one process per source, all at once; the fp32 instances of the warp
     routes of K1-K8, K10 and K12, and the instances of K11's and K13's,
     must not spill (``-Xptxas -v``);
  3. kernels: each kernel against its plain version on the card, at the
     serving and training shape B=64, T=1000, N=30, S=50 with ragged
     lengths, plus small fp64, degenerate-length and wide-label cases; times
     are medians of CUDA-event timings.  K1, K1 with stores and K2 run on
     each route that takes the case's width (the warp route up to 128
     labels and slots, at its width edges in fp32 and fp64; the block route
     in every case), and both routes are timed at the serving and training
     shape, with the microseconds per serial step; one warp-route K2 call
     is profiled by kernel (profile ``k2_warp``).  K2 must give the same
     bits twice on each route.
     K9 (the matmul tier's dual-stream kernel) at the wordpiece shape T=100,
     B=8, N=10,000 (fp32, ragged lengths) and at small fp64 shapes; twice
     with the same bits; and against the two matmul-tier scans, the
     formulation it replaces, which are timed beside it.  K10 and K11
     bit-identical to their plain versions, each on each route that takes
     the width (also at the warp route's width edges), both routes timed,
     one warp-route call of each profiled by kernel (``k10_warp``,
     ``k11_warp``).  K12 and K13 (forced alignment) bit-identical to their
     plain versions at the serving shape, at S=512, on ties, on degenerate
     lengths and at fp64, each on each route that takes the width (also at
     the warp route's width edges), both routes timed, one warp-route call
     of each profiled (``k12_warp``, ``k13_warp``).  K11 and K13 also on
     rows drawn at random, inside their domain and outside it, with final
     labels and end slots outside [0, width) and input lengths 0, 1, T - 1,
     T and T + 1 (``check_backtrace``).  K3-K8 (the per-lattice tier) at the
     training shape, at small fp64 shapes, on degenerate lengths, with -inf
     transitions, with E in and out of shared memory and at the width cap
     N = S = 512; each on each route that takes the width, also at the warp
     routes' width edges; K6's warp route also against the sequential
     recursion, and at each block size it is built for (fp32 and fp64,
     timed); K5 and K8 twice with the same bits on each route; one warp-
     route call of each of K3-K8 profiled by kernel (``lattice_warp``);
  4. grads: the fused tier's gradients (K1 with stores -> K2 ->
     scatter_to_full) and the per-lattice tier's (K3, K6, K7 -> K5, K8 ->
     scatter_to_full) against the log-domain scan tier's, fp64, at the
     training shape;
     native_runtime: g++ builds the native host library
     (``torch_asg_tpu_torch/runtime/csrc/asg_host.cpp``), which must load;
     every host call below passes ``use_native=True``;
  5. serve: the full-width Wav2Letter (random weights from a seed) answers 3
     requests of 64 utterances after one warm-up request: encoder ->
     viterbi_decode -> collapse_path (native) -> asg_scores and asg_loss.
     The first request's native hypotheses must equal the NumPy arm's, and
     its stage split is taken with each arm of collapse_path.  Every
     serving kernel's launch count must rise in those 3 requests, and every
     K1, K10 and K11 launch must take the route 'auto' takes; the outputs
     are checked against the log-domain oracle tiers, one more request,
     synchronised after each stage, shows where its time goes, and one
     asg_scores call is timed and profiled alone, and one viterbi_decode
     call profiled alone (device busy time, idle share);
  6. train: the full-width Wav2Letter takes one warm-up step and 5 timed
     AdamW steps on one fixed batch of 64 utterances, prepared as
     ``examples/train_asg.py`` prepares them (cmvn -> pack_frames ->
     encode_targets, native).  Host prep is timed with each arm, whose
     batches must agree (features within CMVN_TOL, the rest exactly).  Each
     step must launch K1 with stores and K2 once,
     each on the route 'auto' takes, and the score-only K1 never; losses and
     gradients must be finite, the first step's gradients must agree with
     the scan tier's, and the loss must fall.  One more step, synchronised
     after each stage, and the criterion's forward+backward alone (timed and
     profiled) show where the time goes.  Then (``train_prefetch``) the
     model trains on PREFETCH_BATCHES distinct full-width batches of one
     shape three times from one saved model and optimizer state: serially
     (prepare, copy, step), through ``device_prefetch(depth=2)`` (prep and
     copy on a worker thread and a side stream), and on the serial loop's
     batches already on the card (the step's own pace); each prefetched
     batch must equal the serial loop's, tensor for tensor, and every loss
     must be finite; each loop's steps per second, the worker's prep time
     per batch, and the prefetched loop profiled (``train_prefetch``: busy
     time, idle share);
  7. train_wordpiece: the full-width Wav2Letter with a 10,000-wordpiece head
     takes one warm-up step and 5 timed steps on a batch of 8 utterances
     (150-200 feature frames, 5-10 wordpiece targets), so 'auto' runs the
     matmul tier.  Each step must launch K9 once and K1, K1s and K2 never; a
     forward-only asg_scores call must launch no K9; the first step's
     gradients must agree with the two scans', and the loss must fall;
  8. align: the full-width letter model answers 3 alignment requests of 64
     utterances after a warm-up: encoder -> viterbi_align ->
     alignment_segments.  K12 and K13 must launch once a request, each on
     the route 'auto' takes, positions must equal the 'xla' tier's, the
     spans must partition each utterance, and an empty transcript (one
     element a request) must score -inf;
  9. train_pallas: the full-width letter model takes one warm-up step and 5
     timed steps of make_train_step(..., impl='pallas') on ``train``'s
     batch.  Each step must launch K3, K5, K6, K7 and K8 once and K4, K1,
     K1s, K2 and K9 never, K3 and K5-K8 on the route 'auto' takes; the
     first step's gradients must agree with the scan tier's (fp32 with K6 on
     its block route, fp64 on the routes 'auto' takes; fp32 on those routes
     finite, with the entries outside the bound counted) and the loss must
     fall; a score-only asg_scores call must launch K4 and K7 alone,
     each on the route 'auto' takes, and is timed (beside the fused tier's
     score-only call) and profiled (``pallas_scores``); the criterion alone
     is timed and profiled (``pallas_criterion``);
 10. serve_posterior: the full-width letter model answers 3 requests of 64
     utterances after a warm-up: encoder -> posterior_decode ('auto', so the
     per-lattice tier: K3 and K5 once a request, K4 never) ->
     collapse_path.  The posteriors must agree with the scan tier's, and the
     paths wherever the posteriors decide; one request is profiled
     (``posterior_request``);
 11. serve_nbest: the full-width letter model answers 3 n-best requests of
     64 utterances after a warm-up (encoder -> viterbi_nbest(k=4) -> native
     collapse_path of the 4 x 64 hypotheses) and 3 beam requests on the same
     features (encoder -> beam_decode(beam_size=16) -> collapse_path), and
     beam_nbest(n=4, beam_size=16) runs on each request's emissions.  These
     decoders are plain PyTorch (no kernel).  On the card they must equal
     the port's CPU run on the same emissions to the bit, at the letter
     width and at the wordpiece shape (T=100, B=8, N=10,000, beam decoders
     only); rank 0 of viterbi_nbest must equal viterbi_decode (K10 + K11),
     beam_decode at a full beam its scores, rank 0 of beam_nbest
     beam_decode; scores descend along the ranks, and each path rescored on
     the host gives its score within the fp32 accumulation bound.  One
     viterbi_nbest call is profiled (``serve_nbest``);
 12. serve_stream: the full-width letter model encodes 64 utterances once and
     the emissions reach the streaming API in ragged chunks (each stream's
     chunk of 50-150 frames drawn per chunk, so streams advance at different
     rates); after every chunk the stream updates and reads its scores and
     updates its Viterbi, alignment, beam (16) and n-best (k=4) states.  The
     read-outs after the middle chunk and at the end must equal the port's
     one-shot calls on the same prefixes on the card (asg_scores through K1
     within serve's fp32 bound, viterbi_decode through K10 + K11,
     viterbi_align through K12 + K13, beam_decode, beam_nbest,
     viterbi_nbest: paths, positions and labels equal); a float64 stream the
     float64 scan tier's scores within rtol 1e-9, and its paths the same
     stream's on the CPU; the streaming updates launch no kernel of the
     port.  Timed: each surface's update per chunk, the whole-stream request
     (first chunk to hypotheses on the host), one chunk profiled
     (``stream_chunk``);
 13. wfsa: generic acceptors on the card at B=64, T=1000, N=30: the full
     automaton against fcc_score and viterbi_decode (K10 + K11), chains
     against fac_score, fp32 and fp64; a looped 200-word lexicon scored,
     decoded and streamed (equal to the one-shot calls), its posteriors at
     B=8 with their peak memory; wfsa_score, wfsa_posteriors and
     wfsa_viterbi twice each with the same bits (no atomics);
 14. parallel: one rank per card (world = the card count, NCCL, rank r on
     cuda:r; ``parallel.launch.spawn_ranks``, which fails the run on any
     rank's error, exit or timeout).  Each rank: one data-parallel train
     step of the full-width letter model (B=64, the ``train`` batch) through
     ``asg_loss_dp`` ('auto': K1 with stores, K2), its loss and every
     gradient against the single-process ``make_train_step`` within the
     ``train`` bounds, both step times; ``viterbi_decode_dp`` (K10, K11),
     ``beam_decode_dp`` (beam 16) and ``viterbi_align_dp`` (K12, K13, one
     empty transcript) bit for bit against the single-process calls;
     ``asg_loss_vp`` and ``fcc_score_vp`` at the wordpiece width (T=100,
     B=8, N=10,000, S=10) against ``asg_loss`` ('auto': the matmul tier, K9)
     in fp32 within the ``train_wordpiece`` bounds and against the scan tier
     in fp64 within 1e-9, with the call time and peak memory;
     ``asg_loss_seq`` (B=64, T=1000, N=30, S=50, fp64) against the scan tier
     within 1e-9; and on rank 0 the chunk transfer matrices of 4 time
     chunks folded in one process, against the scan tier.  Every rank's
     K1-with-stores, K2 and K10-K13 counts must rise.  Then, in this
     process: checkpoint resume of the letter train state (saved after
     step 2, restored into a fresh state: step 3 bit-identical), the three
     ``examples/*_torch.py`` at their defaults, and one serving request
     timed by ``utils.profiling.time_fn_chained`` beside its CUDA-event
     median;
 15. the kernel table (every kernel launched on its path), the nvidia-smi
     line, and last the result line.

Precision: float32 matrix products and convolutions run in full float32
(TF32 off for both cuBLAS and cuDNN).  Exits nonzero, printing no result,
when no CUDA device is available.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
B, T, N, S = 64, 1000, 30, 50
ALPHABET, MAX_REPS = 28, 2  # 28 letters + 2 repeat symbols = N labels
FEATURES = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RUNS = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, runs=RUNS, warmup=2):
    """Median wall time of ``fn`` on the card over ``runs`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lattice_case(rng, dev, dtype, b, t, n, s, li_range, lo_range, integer=False):
    """Seeded lattice inputs; a length range (low, high) draws ragged
    lengths, a list gives them as they are."""
    if integer:
        inputs = rng.integers(-2, 3, size=(t, b, n))
        trans = rng.integers(-1, 2, size=(n, n))
    else:
        inputs = rng.normal(size=(t, b, n))
        trans = rng.normal(size=(n, n)) * 0.5
    targets = rng.integers(0, n, size=(b, s))
    li, lo = (r if isinstance(r, list) else rng.integers(r[0], r[1] + 1, size=b)
              for r in (li_range, lo_range))

    def cast(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    return (cast(trans, dtype), cast(inputs, dtype), cast(targets, torch.int32),
            cast(li, torch.int32), cast(lo, torch.int32))


def k1_args(case):
    """K1's arguments for a ``lattice_case``."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak

    trans, inputs, targets, li, lo = case
    lat, e, _ = ak._prepare(trans, inputs, targets, li, lo)
    return (e, lat.self_trans.contiguous(), lat.next_trans.contiguous(),
            inputs.contiguous(), lat.inputs.contiguous(), li, lo)


def width_routes(*widths):
    """The routes of K1, K2, K3, K5, K8 and K10 that take rows of these
    widths."""
    from torch_asg_tpu_torch.ops.kernels.common import WARP_MAX_WIDTH

    return ("warp", "block") if max(widths) <= WARP_MAX_WIDTH else ("block",)


# The warp routes' width edges (K1's and K2's), fp32 and fp64: (N, S) = (32, 32),
# (33, 64), (64, 65) and (128, 128), the last label or slot in lane 31 of a
# lane's last register, and four more shapes so that every pair of label
# and slot register counts (1, 2 or 4 each) is run.
K1_WIDTH_CASES = tuple(
    (f"{'fp32' if dt == torch.float32 else 'fp64'}_n{n}_s{s}", dt, (5, 300, n, s),
     (max(n, s), 300), (1, s))
    for dt in (torch.float32, torch.float64)
    for n, s in ((32, 32), (33, 64), (64, 65), (128, 128), (20, 100), (100, 20),
                 (64, 16), (100, 64)))


def time_routes(wrapper, args, serial_steps, auto):
    """A two-route kernel's wrapper's times at the serving and training
    shape, both routes in one run (``ms_warp``, ``ms_block``; ``ms`` is the
    route 'auto' takes, ``auto``), and µs per serial step."""
    out = {"route_auto": auto}
    for route in ("warp", "block"):
        out[f"ms_{route}"] = time_ms(lambda: wrapper(*args, route=route))
    out["ms"] = out[f"ms_{auto}"]
    out["us_per_step"] = out["ms"] / serial_steps * 1e3
    out["us_per_step_by_route"] = {r: out[f"ms_{r}"] / serial_steps * 1e3
                                   for r in ("warp", "block")}
    return out


def check_k1(rng, dev):
    """K1 against its plain version on each route that takes the case's
    width: fp32 at the serving shape (both routes timed); fp64 at a small
    shape and on degenerate lengths (L_in = 1, L_out = 1, L_out > L_in,
    L_in outside [1, T]); the warp route's width edges (K1_WIDTH_CASES); on
    the block route fp32 with E in opted-in shared memory (N=200), with E in
    global memory (N=300), and at the widest widths the front-end takes."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    results = {}
    f64, f32 = torch.float64, torch.float32
    tol = {f64: (1e-10, 1e-10), f32: (1e-4, 1e-3)}
    edge_rng = np.random.default_rng([SEED, 6])  # keeps ``rng``'s stream as it was
    edges = {c[0] for c in K1_WIDTH_CASES}
    for name, dtype, (b, t, n, s), li_r, lo_r in (
        ("fp64_small", f64, (4, 40, 12, 9), (9, 40), (1, 9)),
        ("fp64_degenerate", f64, (7, 40, 12, 9), [1, 40, 2, 3, 17, 0, 41],
         [1, 1, 4, 9, 3, 2, 2]),
        *K1_WIDTH_CASES,
        ("fp32_n200_smem", f32, (4, 60, 200, 20), (20, 60), (1, 20)),
        ("fp32_n300_global", f32, (4, 60, 300, 20), (20, 60), (1, 20)),
        ("fp32_max_width", f32, (2, 600, 512, 512), (512, 600), (1, 512)),
        ("fp32_serving", f32, (B, T, N, S), (500, 1000), (10, 50)),
    ):
        case_rng = edge_rng if name in edges else rng
        args = k1_args(lattice_case(case_rng, dev, dtype, b, t, n, s, li_r, lo_r))
        want = ak._fwd_scores_plain(*args)
        results[name] = {}
        for route in width_routes(n, s):
            got = ak._fwd_scores_kernel(*args, route=route)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(not bool(torch.isnan(g).any()), f"K1 {route} {name}: NaN scores")
                torch.testing.assert_close(g, w, rtol=tol[dtype][0], atol=tol[dtype][1],
                                           msg=lambda m: f"K1 {route} {name}: {m}")
            if name == "fp64_degenerate":
                # L_out > L_in: unalignable; L_in outside [1, T]: no path at all
                check(bool((got[1][[2, 3, 5, 6]] == -np.inf).all())
                      and bool((got[0][[5, 6]] == -np.inf).all()),
                      f"K1 {route}: elements without a path must score -inf")
            else:
                check(bool(torch.isfinite(got[0]).all()),
                      f"K1 {route} {name}: non-finite full scores")
            results[name][route] = max(max_err(g, w) for g, w in zip(got, want))
    li = args[5]  # the serving case's
    lsum = int(li.sum())
    nbytes = (lsum * (N + S) + N * N + 2 * B * S) * 4 + 2 * B * 4 + 2 * B * 4
    ops = (lsum - B) * (2 * N * N + 4 * N + 8 * S)
    bound_ms, bound_by = bound(nbytes, ops)
    serial_steps = int(li.max()) - 1
    times = time_routes(ak._fwd_scores_kernel, args, serial_steps, width_route(max(N, S)))
    return {
        "name": "asg_fwd_scores (K1, score-only)",
        "max_abs_err": results["fp32_serving"][times["route_auto"]],
        "max_abs_err_by_case": results,
        "tolerance": "fp32 rtol 1e-4 atol 1e-3 (1000 serial steps, other sum order); fp64 1e-10",
        **times,
        "plain_ms": time_ms(lambda: ak._fwd_scores_plain(*args)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "serial_steps": serial_steps,
    }


def route_launches(reset=False):
    """K1's (both variants), K2's, K10's and K11's launches by route,
    {"<wrapper>.<route>": n}; with ``reset`` the counts are set to 0
    first."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak
    from torch_asg_tpu_torch.ops.kernels.common import ROUTES
    from torch_asg_tpu_torch.ops.kernels.viterbi_kernels import (viterbi_backtrace_pallas,
                                                                 viterbi_forward_pallas)

    out = {}
    for wrapper in (ak._fwd_scores_kernel, ak._fwd_store_kernel, ak._bwd_kernel,
                    viterbi_forward_pallas, viterbi_backtrace_pallas):
        for route in ROUTES:
            if reset:
                setattr(wrapper, f"launches_{route}", 0)
            out[f"{wrapper.__name__}.{route}"] = getattr(wrapper, f"launches_{route}")
    return out


def check_auto_route(scores, store, bwd, vit=0):
    """Since the last reset, the score-only K1 launched ``scores`` times, K1
    with stores ``store`` times, K2 ``bwd`` times and K10 and K11 ``vit``
    times each (one decode), each through the route 'auto' takes at N, S
    (K10, K11: at N)."""
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    got = route_launches()
    route, vit_route = width_route(max(N, S)), width_route(N)
    want = dict.fromkeys(got, 0)
    want.update({f"_fwd_scores_kernel.{route}": scores, f"_fwd_store_kernel.{route}": store,
                 f"_bwd_kernel.{route}": bwd, f"viterbi_forward_pallas.{vit_route}": vit,
                 f"viterbi_backtrace_pallas.{vit_route}": vit})
    check(got == want,
          f"every K1, K2, K10 and K11 launch must take the route 'auto' takes: {got}")
    return got


# K10's warp-route width edges, fp32 and fp64, on integer emissions that
# force ties (from their own seeded stream): N = 32, 33, 64, 65 and 128, the
# last label in lane 31 of a lane's last register, so that every label
# register count (1, 2 or 4) runs, with the transition in registers (N <=
# 32) and in the warp route's shared memory (fp64 N = 128: 130 KB).
VITERBI_WIDTH_CASES = tuple(
    (f"{'fp32' if dt == torch.float32 else 'fp64'}_n{n}_integer_ties", dt, (3, 200, n),
     (100, 200), True)
    for dt in (torch.float32, torch.float64) for n in (32, 33, 64, 65, 128))
# K10's warp route in a device profile: its two kernels, by name.
K10_WARP_PHASES = ("viterbi_fwd_warp_kernel", "viterbi_bp_kernel")
# K11's and K13's warp routes in a device profile: one kernel each.
K11_WARP_PHASES = ("viterbi_backtrace_warp_kernel",)
K13_WARP_PHASES = ("align_backtrace_warp_kernel",)
# K11's and K13's own cases, on rows drawn at random rather than taken from
# K10 or K12 (each kernel from a seeded stream of its own): widths 1 and 5,
# the serving widths 30 and 50, the warp route's edges 32, 33, 64, 65 and
# 128, and 129 and 300 on the block route alone; rows inside the kernels'
# domain (backpointers in [0, W), advance bits in {0, 1}) and outside it
# (backpointers in [-3, W + 3), advance values in [-1, 3)); every pair of an
# input length in BACKTRACE_LENGTHS and a start value (K11: final labels -1,
# 0, W - 1, W and W + 5; K13: end slots -1, 0, W - 1, W + 3 and W // 2), then
# 7 elements of random lengths in [1, T] and starts in [0, W).
BACKTRACE_WIDTHS = (1, 5, 30, 32, 33, 50, 64, 65, 128, 129, 300)
BACKTRACE_T = 200
BACKTRACE_LENGTHS = (0, 1, BACKTRACE_T - 1, BACKTRACE_T, BACKTRACE_T + 1)


def check_backtrace(kernel, rng, dev):
    """K11 or K13 (``kernel``) bit-identical to its plain version on each
    route that takes the width, in every case of BACKTRACE_WIDTHS; returns
    {case: routes run}."""
    from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk

    if kernel == "K11":
        wrapper, plain = vk.viterbi_backtrace_pallas, vk.viterbi_backtrace_plain
    else:
        wrapper, plain = vk.align_backtrace_pallas, vk.align_backtrace_plain
    t = BACKTRACE_T
    runs = {}
    for w in BACKTRACE_WIDTHS:
        if kernel == "K11":
            starts = (-1, 0, w - 1, w, w + 5)
            domains = {"valid": (0, w), "wild": (-3, w + 3)}
        else:
            starts = (-1, 0, w - 1, w + 3, w // 2)
            domains = {"valid": (0, 2), "wild": (-1, 3)}
        li = [n for n in BACKTRACE_LENGTHS for _ in starts] + list(rng.integers(1, t + 1, 7))
        st = [x for _ in BACKTRACE_LENGTHS for x in starts] + list(rng.integers(0, w, 7))
        li, st = (torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
                  for x in (li, st))
        for domain, (lo, hi) in domains.items():
            rows = torch.as_tensor(rng.integers(lo, hi, size=(t, len(li), w)),
                                   dtype=torch.int32, device=dev)
            want = plain(st, rows, li)
            name = f"w{w}_{domain}"
            runs[name] = width_routes(w)
            for route in width_routes(w):
                got = wrapper(st, rows, li, route=route)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"{kernel} {route} {name}: outputs differ")
    return runs


def check_viterbi(rng, dev):
    """K10 and K11 against their plain versions: bit-identical backpointers,
    end rows and paths, on random and on integer (tie-forcing) emissions, on
    degenerate lengths, with the transition in global memory (N=300), at
    the kernel's label cap, and at the warp route's width edges
    (VITERBI_WIDTH_CASES); K11 also on its own cases (``check_backtrace``);
    each on each route that takes the case's width.  Both routes of each
    timed at the serving shape, and their warp routes' kernels by device
    time (the profiles ``k10_warp`` and ``k11_warp``)."""
    from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    cases = (
        ("fp32_serving", torch.float32, (B, T, N), (500, T), False),
        ("fp32_integer_ties", torch.float32, (B, T, N), (500, T), True),
        ("fp64_small", torch.float64, (4, 40, 12), (20, 40), False),
        ("fp32_degenerate", torch.float32, (4, 50, 30), [1, 2, 50, 49], False),
        ("fp32_n300_global", torch.float32, (4, 60, 300), (30, 60), False),
        ("fp32_label_cap", torch.float32, (2, 20, vk.VITERBI_KERNEL_MAX_LABELS), (10, 20), False),
    )
    width_rng = np.random.default_rng([SEED, 10])  # keeps ``rng``'s stream as it was
    widths = {c[0] for c in VITERBI_WIDTH_CASES}
    serving, errs, routes_run = None, {}, {}
    for name, dtype, (b, t, n), li_r, integer in cases + VITERBI_WIDTH_CASES:
        case_rng = width_rng if name in widths else rng
        trans, inputs, _, li, _ = lattice_case(case_rng, dev, dtype, b, t, n, 1, li_r, [1] * b,
                                               integer)
        d_ref, bp_ref = vk.viterbi_forward_plain(trans, inputs, li)
        routes_run[name] = width_routes(n)
        for route in width_routes(n):
            d_end, bp = vk.viterbi_forward_pallas(trans, inputs, li, route=route)
            torch.cuda.synchronize()
            check(torch.equal(bp, bp_ref), f"K10 {route} {name}: backpointers differ")
            check(torch.equal(d_end, d_ref), f"K10 {route} {name}: end rows differ")
            if route == width_route(n):
                d_auto = d_end
        _, final = vk.argmax_first(d_ref, dim=1)
        path_ref = vk.viterbi_backtrace_plain(final, bp_ref, li)
        for route in width_routes(n):
            path = vk.viterbi_backtrace_pallas(final, bp_ref, li, route=route)
            torch.cuda.synchronize()
            check(torch.equal(path, path_ref), f"K11 {route} {name}: paths differ")
            if route == width_route(n):
                path_auto = path
        if name == "fp32_serving":
            serving = (trans, inputs, li, final, bp_ref)
            same = d_auto == d_ref  # also where both are -inf
            errs["k10"] = float(torch.where(same, 0.0, (d_auto - d_ref).abs()).max())
            errs["k11"] = float((path_auto - path_ref).abs().max())
    k11_routes = {**routes_run, **check_backtrace("K11", np.random.default_rng([SEED, 13]), dev)}
    trans, inputs, li, final, bp = serving
    lsum = int(li.sum())
    fwd_bytes = (lsum * N + N * N + B + T * B * N + B * N) * 4
    fwd_ops = 2 * T * B * N * N
    bt_bytes = (lsum - B + 2 * B + T * B) * 4
    k10_bound, k10_by = bound(fwd_bytes, fwd_ops)
    k11_bound, k11_by = bound(bt_bytes, 0)
    exact = "bit-identical (max-plus is exact)"
    split = profile_call("k10_warp")
    check(split["complete"], f"K10's warp route must run its two kernels: {split}")
    bt_split = profile_call("k11_warp")
    check(bt_split["complete"], f"K11's warp route must run its kernel: {bt_split}")
    serial_steps = int(li.max()) - 1
    k10 = {
        "name": "viterbi_forward (K10)", "max_abs_err": errs["k10"], "tolerance": exact,
        "routes_by_case": routes_run,
        **time_routes(vk.viterbi_forward_pallas, (trans, inputs, li), serial_steps,
                      width_route(N)),
        "warp_device_ms": {p: split["phase_ms"][p] for p in K10_WARP_PHASES},
        "plain_ms": time_ms(lambda: vk.viterbi_forward_plain(trans, inputs, li)),
        "bound_ms": k10_bound, "bound_by": k10_by, "serial_steps": serial_steps,
    }
    k11 = {
        "name": "viterbi_backtrace (K11)", "max_abs_err": errs["k11"],
        "tolerance": "bit-identical (integer lookups)",
        "routes_by_case": k11_routes,
        # the warp route's chain: frames min(L_in, T) - 2 .. 0, K10's step count
        **time_routes(vk.viterbi_backtrace_pallas, (final, bp, li), serial_steps,
                      width_route(N)),
        "warp_device_ms": {p: bt_split["phase_ms"][p] for p in K11_WARP_PHASES},
        "plain_ms": time_ms(lambda: vk.viterbi_backtrace_plain(final, bp, li)),
        "bound_ms": k11_bound, "bound_by": k11_by, "serial_steps": serial_steps,
    }
    return k10, k11


def max_err(got, want):
    """Largest |got - want| where ``want`` is finite (infinities must match)."""
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)) and
          torch.equal(got[~fin], want[~fin]), "infinities differ")
    return float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0


def assert_near(name, got, want, rtol, atol_rel):
    """|got - want| <= rtol |want| + atol_rel * max|want| on finite entries,
    equal infinities, no NaN."""
    check(not bool(torch.isnan(got).any()), f"{name}: NaN")
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * max(scale, 1e-30),
                               msg=lambda m: f"{name}: {m}")


def outside(got, want, rtol, atol_rel):
    """How many entries of ``got`` lie outside ``assert_near``'s bound around
    ``want``."""
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    bound = rtol * want.abs() + atol_rel * max(scale, 1e-30)
    return int(((got - want).abs() > bound)[fin].sum())


# (name, dtype, (B, T, N, S), L_in, L_out) for K1 with stores and K2; a
# length range (low, high) draws ragged lengths, a list gives them.  K2
# keeps its transition accumulator and E^T in shared memory at N=30 and in
# the fp64 cases, the accumulator alone at N=200, neither at N=300 and 512.
TRAIN_CASES = (
    ("fp64_small", torch.float64, (4, 40, 12, 9), (9, 40), (1, 9)),
    ("fp64_degenerate", torch.float64, (7, 40, 12, 9), [1, 40, 2, 3, 17, 0, 41],
     [1, 1, 4, 9, 3, 2, 2]),
    ("fp32_n200_smem", torch.float32, (4, 60, 200, 20), (20, 60), (1, 20)),
    ("fp32_n300_global", torch.float32, (4, 60, 300, 20), (20, 60), (1, 20)),
    ("fp32_max_width", torch.float32, (2, 600, 512, 512), (512, 600), (1, 512)),
    ("fp32_training", torch.float32, (B, T, N, S), (500, 1000), (10, 50)),
)
# K1 with stores: scores and QB (log domain) as K1's, PB (exp domain, rows
# rescaled to max 1) relative.  K2: every output relative to its own scale.
# fp32 bounds cover 1000 serial steps summed in another order; fp64 is the
# same arithmetic to rounding.
K1S_TOL = {torch.float64: {"scores": (1e-10, 1e-10), "pb": (1e-9, 1e-12), "qb": (1e-10, 1e-10)},
           torch.float32: {"scores": (1e-4, 1e-3), "pb": (1e-3, 1e-6), "qb": (1e-4, 1e-3)}}
K2_TOL = {torch.float64: (1e-9, 1e-12), torch.float32: (1e-3, 1e-5)}


def check_k1s(args, name):
    """K1 with stores against its plain version on each route that takes
    the width: {route: max abs error}, and the plain version's outputs."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak

    want = ak._fwd_store_plain(*args)
    tol = K1S_TOL[args[3].dtype]
    errs = {}
    for route in width_routes(args[3].shape[2], args[4].shape[2]):
        got = ak._fwd_store_kernel(*args, route=route)
        torch.cuda.synchronize()
        for label, g, w in zip(("pb", "qb", "sful", "sfac"), got, want):
            assert_near(f"K1s {route} {name} {label}", g, w, *tol.get(label, tol["scores"]))
        errs[route] = max(max_err(g, w) for g, w in zip(got, want))
    return errs, want


K2_OUTPUTS = ("gI", "gA", "dT", "gself", "gnext")
# K2's warp route in a device profile: its three kernels, by name.
K2_WARP_PHASES = ("asg_bwd_warp_chain_kernel", "asg_bwd_warp_post_kernel",
                  "asg_bwd_warp_sums_kernel")


def check_k2(bargs, name):
    """K2 against its plain version on each route that takes the width, on
    the same inputs: two calls give the same bits, no output is non-finite,
    every output within K2_TOL, and elements with L_in outside [1, T] get
    zero gradients.  {route: max abs error}."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak

    inputs, aligned, li = bargs[3], bargs[4], bargs[5]
    t = inputs.shape[0]
    no_path = ((li < 1) | (li > t)).nonzero().flatten()
    want = ak._bwd_plain(*bargs)
    errs = {}
    for route in width_routes(inputs.shape[2], aligned.shape[2]):
        got = ak._bwd_kernel(*bargs, route=route)
        again = ak._bwd_kernel(*bargs, route=route)
        torch.cuda.synchronize()
        for label, g, g2, w in zip(K2_OUTPUTS, got, again, want):
            check(torch.equal(g, g2), f"K2 {route} {name} {label}: two runs differ")
            check(bool(torch.isfinite(g).all()), f"K2 {route} {name} {label}: non-finite")
            assert_near(f"K2 {route} {name} {label}", g, w, *K2_TOL[inputs.dtype])
        check(all(bool((x[:, no_path] == 0).all()) for x in got[:2])
              and all(bool((x[no_path] == 0).all()) for x in got[3:]),
              f"K2 {route} {name}: elements without a path must have zero gradients")
        errs[route] = max(max_err(g, w) for g, w in zip(got, want))
    return errs


def check_k1s_k2(rng, dev):
    """K1 with stores and K2, each on every route that takes the width,
    against its plain version on the card in every case of TRAIN_CASES and
    at the warp routes' width edges (K1_WIDTH_CASES).  K2 runs on the plain
    version's residuals, so both K2 versions see the same inputs.  Both
    routes of each timed at the training shape, and one warp-route K2 call
    profiled by kernel."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    errs1, errs2 = {}, {}
    edge_rng = np.random.default_rng([SEED, 61])  # keeps ``rng``'s stream as it was
    edge_grad_rng = np.random.default_rng([SEED, 62])  # and ``edge_rng``'s

    def k2_args(args, want, b, dtype, g_rng):
        g_full = torch.as_tensor(g_rng.uniform(0.5, 1.5, size=b), dtype=dtype, device=dev)
        g_fac = -torch.as_tensor(g_rng.uniform(0.5, 1.5, size=b), dtype=dtype, device=dev)
        return args[:6] + (want[0], want[1], g_full, g_fac)

    for name, dtype, (b, t, n, s), li_r, lo_r in K1_WIDTH_CASES:
        args = k1_args(lattice_case(edge_rng, dev, dtype, b, t, n, s, li_r, lo_r))
        errs1[name], want = check_k1s(args, name)
        errs2[name] = check_k2(k2_args(args, want, b, dtype, edge_grad_rng), name)
    for name, dtype, (b, t, n, s), li_r, lo_r in TRAIN_CASES:
        args = k1_args(lattice_case(rng, dev, dtype, b, t, n, s, li_r, lo_r))
        li = args[5]
        errs1[name], want = check_k1s(args, name)
        bargs = k2_args(args, want, b, dtype, rng)
        errs2[name] = check_k2(bargs, name)
    # the training-shape case's inputs: timing and bounds
    lsum = int(li.sum())
    w = 4  # float32 bytes
    k1s_bytes = ((lsum * (N + S) + N * N + 2 * B * S) * w + 2 * B * 4 + 2 * B * w
                 + T * B * (N + S) * w)
    k1s_ops = (lsum - B) * (2 * N * N + 4 * N + 8 * S)
    # K2's bound counts the TPU kernel's inputs and outputs alone, each read
    # or written once, so that it reads the same whatever implements it:
    # I, A, PB, QB over the frames t < L_in; E and E^T; self and next;
    # L_in; g_full and g_fac; gI and gA (all T rows); dT; gself and gnext.
    # Operations: the alpha contraction and the rank-one update (4 N^2 a
    # frame) and the softmaxes and edge fractions; dT's product with E.
    k2_bytes = (lsum * 2 * (N + S) * w + 2 * N * N * w + 2 * B * S * w + B * 4 + 2 * B * w
                + T * B * (N + S) * w + N * N * w + 2 * B * S * w)
    k2_ops = lsum * (4 * N * N + 16 * N + 24 * S) + N * N
    k1s_bound, k1s_by = bound(k1s_bytes, k1s_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    tol1 = "; ".join(f"{k} rtol {r:g} atol {a:g}" for k, (r, a) in K1S_TOL[torch.float32].items())
    serial_steps = int(li.max()) - 1
    auto = width_route(max(N, S))
    times = time_routes(ak._fwd_store_kernel, args, serial_steps, auto)
    k2_times = time_routes(ak._bwd_kernel, bargs, int(li.max()), auto)
    k2_profile = profile_call("k2_warp")
    check(all(v > 0 for v in k2_profile["phase_ms"].values()),
          f"K2's warp route must run its three kernels: {k2_profile['phase_ms']}")
    k1s = {
        "name": "asg_fwd_store (K1 with stores)",
        "max_abs_err": errs1["fp32_training"][times["route_auto"]],
        "max_abs_err_by_case": errs1,
        "tolerance": f"fp32 {tol1} (1000 serial steps, other sum order); fp64 1e-10",
        **times,
        "plain_ms": time_ms(lambda: ak._fwd_store_plain(*args), runs=5, warmup=1),
        "bound_ms": k1s_bound, "bound_by": k1s_by, "serial_steps": serial_steps,
    }
    k2 = {
        "name": "asg_bwd (K2)", "max_abs_err": errs2["fp32_training"][k2_times["route_auto"]],
        "max_abs_err_by_case": errs2,
        "tolerance": ("fp32 rtol 1e-3, atol 1e-5 x max|output| per output (1000 serial "
                      "steps, other sum order); fp64 rtol 1e-9, atol 1e-12 x max; two "
                      "runs bit-identical on each route"),
        **k2_times,
        "warp_profile": k2_profile, "warp_device_ms": k2_profile["phase_ms"],
        "plain_ms": time_ms(lambda: ak._bwd_plain(*bargs), runs=5, warmup=1),
        "bound_ms": k2_bound, "bound_by": k2_by, "serial_steps": int(li.max()),
    }
    return k1s, k2


# The wordpiece shape (bench.py's 10k row): T=100 frames, B=8, N=10,000.
WP_T, WP_B, WP_N, WP_S = 100, 8, 10_000, 10
# K9: fp32 bounds cover 99 paired steps of 10,000-term sums taken in another
# order (K1's tolerance for a long serial chain); fp64 is the same
# arithmetic to rounding.
K9_TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-4, 1e-3)}


def k9_case(rng, dev, dtype, t, b, n, lengths=None, scale=1.0, neg_inf=False):
    """(transition, masked emissions, input lengths) for K9; lengths None
    draws them in [1, T] with the first at T."""
    from torch_asg_tpu_torch.utils.lengths import mask_emissions

    np_dt = np.float32 if dtype == torch.float32 else np.float64
    trans = rng.standard_normal((n, n), dtype=np_dt) * np_dt(scale)
    if neg_inf:
        trans[:, 3] = -np.inf
        trans[5, :] = -np.inf
    inputs = rng.standard_normal((t, b, n), dtype=np_dt)
    if lengths is None:
        lengths = rng.integers(1, t + 1, size=b)
        lengths[0] = t
    li = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=dev)
    trans, inputs = (torch.as_tensor(x, device=dev) for x in (trans, inputs))
    return trans, mask_emissions(inputs, li), li


def check_k9(rng, dev):
    """K9 against its plain version: fp64 at small shapes (N past a tile's
    512 columns, T = 1 and 2, -inf transitions, more than 8 elements) and
    fp32 at the wordpiece shape, where it must also give the same bits
    twice and agree with the two matmul-tier scans."""
    from torch_asg_tpu_torch.ops import fcc
    from torch_asg_tpu_torch.ops.kernels import bigvocab_kernels as bk

    f64, f32 = torch.float64, torch.float32
    wp_li = rng.integers(WP_T // 2, WP_T + 1, size=WP_B)
    wp_li[0] = WP_T
    cases = (
        ("fp64_n130", f64, (6, 3, 130), None, False),
        ("fp64_n260", f64, (9, 2, 260), None, False),
        ("fp64_n600_b9", f64, (5, 9, 600), None, False),
        ("fp64_t1", f64, (1, 3, 140), [1, 1, 1], False),
        ("fp64_t2", f64, (2, 1, 128), [2], False),
        ("fp64_neg_inf_row_col", f64, (7, 2, 150), None, True),
        ("fp32_wordpiece", f32, (WP_T, WP_B, WP_N), wp_li, False),
    )
    errs = {}
    for name, dtype, (t, b, n), lengths, neg_inf in cases:
        scale = 0.1 if name == "fp32_wordpiece" else 1.0  # bench.py's 10k transition
        args = k9_case(rng, dev, dtype, t, b, n, lengths, scale, neg_inf)
        got = bk.fcc_dual_streams(*args)
        want = bk.fcc_dual_streams_plain(*args)
        torch.cuda.synchronize()
        rtol, atol = K9_TOL[dtype]
        for label, g, w in zip(("alpha", "beta"), got, want):
            check(not bool(torch.isnan(g).any()), f"K9 {name} {label}: NaN")
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"K9 {name} {label}: {m}")
        errs[name] = max(max_err(g, w) for g, w in zip(got, want))
    again = bk.fcc_dual_streams(*args)
    check(all(torch.equal(g, a) for g, a in zip(got, again)), "K9: two runs differ")
    trans, xm, li = args

    def scans():
        return fcc._alpha_scan_mm(trans, xm), fcc._beta_scan_mm(trans, xm, li)

    ref = scans()
    for label, g, w in zip(("alpha", "beta"), got, ref):
        torch.testing.assert_close(g, w, rtol=K9_TOL[f32][0], atol=K9_TOL[f32][1],
                                   msg=lambda m: f"K9 vs the scans {label}: {m}")
    err_scans = max(max_err(g, w) for g, w in zip(got, ref))
    w = 4  # float32 bytes
    io_bytes = (WP_T * WP_B * WP_N + WP_B) * w + 2 * WP_T * WP_B * WP_N * w
    ops = (WP_T - 1) * 4 * WP_B * WP_N * WP_N
    bound_ms, bound_by = bound(io_bytes + WP_N * WP_N * w, ops)
    # E read once per paired step: it cannot stay on the chip (N^2 = 400 MB)
    e_per_step_ms, _ = bound(io_bytes + WP_T * WP_B * WP_N * w
                             + (WP_T - 1) * WP_N * WP_N * w, ops)
    rtol, atol = K9_TOL[f32]
    return {
        "name": "fcc_dual_streams (K9)", "max_abs_err": errs["fp32_wordpiece"],
        "max_abs_err_by_case": errs, "max_abs_err_vs_matmul_scans": err_scans,
        "tolerance": (f"fp32 rtol {rtol:g} atol {atol:g} (99 paired steps of 10,000-term "
                      "sums in another order), also against the two scans; fp64 1e-10; "
                      "two runs bit-identical"),
        "shape": [WP_T, WP_B, WP_N],
        "ms": time_ms(lambda: bk.fcc_dual_streams(trans, xm, li)),
        "plain_ms": time_ms(lambda: bk.fcc_dual_streams_plain(trans, xm, li), runs=5, warmup=1),
        "matmul_scans_ms": time_ms(scans, runs=5, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_e_read_per_paired_step": e_per_step_ms,
        "serial_steps": WP_T - 1,
    }


# K12's warp-route width edges and degenerate lengths (from their own seeded
# stream): S = 32, 33, 64, 65 and 128 slots, the last slot in lane 31 of a
# lane's last register, so that every slot register count (1, 2 or 4) runs,
# on integer scores that force ties, fp32 and fp64; and input lengths 0 and
# T + 1 and target lengths 0 and S + 1, where no alignment exists.
ALIGN_WIDTH_CASES = tuple(
    (f"{'fp32' if dt == torch.float32 else 'fp64'}_s{s}_integer_ties", dt, (3, 300, N, s),
     (150, 300), (s // 2, s), True)
    for dt in (torch.float32, torch.float64) for s in (32, 33, 64, 65, 128)) + (
    ("fp32_degenerate_outside", torch.float32, (5, 50, N, 6), [0, 51, 1, 50, 50],
     [2, 3, 1, 0, 7], False),
    ("fp64_degenerate_outside", torch.float64, (5, 50, N, 6), [0, 51, 1, 50, 50],
     [2, 3, 1, 0, 7], True),
)
# K12's warp route in a device profile: its one kernel.
K12_WARP_PHASES = ("align_forward_warp_kernel",)


def check_align_kernels(rng, dev):
    """K12 and K13 against their plain versions: bit-identical advance bits
    in every (t, b, s), end rows and positions at the serving shape, with
    integer (tie-forcing) scores, at S=512, on degenerate lengths, at fp64
    and at the warp route's width edges (ALIGN_WIDTH_CASES); K13 also on
    its own cases (``check_backtrace``); each on each route that takes the
    case's width, both routes of each timed at the serving shape.  K13 runs
    on the plain version's bits, so both K13 versions see the same inputs.
    The warp routes' kernels by device time (the profiles ``k12_warp`` and
    ``k13_warp``)."""
    from torch_asg_tpu_torch.ops.fac import make_aligned
    from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    cases = (
        ("fp32_serving", torch.float32, (B, T, N, S), (500, T), (10, S), False),
        ("fp32_integer_ties", torch.float32, (B, T, N, S), (500, T), (10, S), True),
        ("fp32_s512", torch.float32, (2, 600, N, vk.ALIGN_KERNEL_MAX_WIDTH), (512, 600),
         (1, 512), False),
        ("fp64_small", torch.float64, (4, 40, 12, 9), (9, 40), (1, 9), False),
        ("fp32_degenerate", torch.float32, (4, 50, N, 6), [1, 2, 50, 49], [1, 2, 6, 3],
         False),
    )
    edge_rng = np.random.default_rng([SEED, 12])  # keeps ``rng``'s stream as it was
    edges = {c[0] for c in ALIGN_WIDTH_CASES}
    serving, routes_run = None, {}
    for name, dtype, (b, t, n, s), li_r, lo_r, integer in cases + ALIGN_WIDTH_CASES:
        case_rng = edge_rng if name in edges else rng
        trans, inputs, targets, li, lo = lattice_case(case_rng, dev, dtype, b, t, n, s, li_r,
                                                      lo_r, integer)
        lat = make_aligned(trans, inputs, targets, li, lo)
        end_s = (lo - 1).to(torch.int32)
        d_ref, adv_ref = vk.align_forward_plain(lat, li)
        routes_run[name] = width_routes(s)
        for route in width_routes(s):
            d_end, adv = vk.align_forward_pallas(lat, li, route=route)
            torch.cuda.synchronize()
            check(torch.equal(adv, adv_ref), f"K12 {route} {name}: advance bits differ")
            check(torch.equal(d_end, d_ref), f"K12 {route} {name}: end rows differ")
        pos_ref = vk.align_backtrace_plain(end_s, adv_ref, li)
        for route in width_routes(s):
            pos = vk.align_backtrace_pallas(end_s, adv_ref, li, route=route)
            torch.cuda.synchronize()
            check(torch.equal(pos, pos_ref), f"K13 {route} {name}: positions differ")
        if name == "fp32_serving":
            serving = (lat, li, end_s, adv_ref)
    lat, li, end_s, adv = serving
    w = 4
    lsum = int(li.sum())
    k12_bytes = (2 * T * B * S + 2 * B * S + B * S) * w + B * 4
    k12_ops = 5 * (T - 1) * B * S
    k13_bytes = (lsum - B + 2 * B + T * B) * 4
    k12_bound, k12_by = bound(k12_bytes, k12_ops)
    k13_bound, k13_by = bound(k13_bytes, 0)
    exact = "bit-identical (max-plus is exact)"
    serial_steps = min(int(li.max()), T - 1)  # the warp route's chain: rows 1 .. L_in
    bt_steps = int(li.max()) - 1  # K13's warp route: frames min(L_in, T) - 2 .. 0
    split = profile_call("k12_warp")
    check(split["complete"], f"K12's warp route must run its kernel: {split}")
    bt_split = profile_call("k13_warp")
    check(bt_split["complete"], f"K13's warp route must run its kernel: {bt_split}")
    k13_routes = {**routes_run, **check_backtrace("K13", np.random.default_rng([SEED, 14]), dev)}
    k12 = {
        "name": "align_forward (K12)", "max_abs_err": 0.0, "tolerance": exact,
        "routes_by_case": routes_run,
        **time_routes(vk.align_forward_pallas, (lat, li), serial_steps, width_route(S)),
        "warp_device_ms": {p: split["phase_ms"][p] for p in K12_WARP_PHASES},
        "plain_ms": time_ms(lambda: vk.align_forward_plain(lat, li), runs=5, warmup=1),
        "bound_ms": k12_bound, "bound_by": k12_by, "serial_steps": serial_steps,
    }
    k13 = {
        "name": "align_backtrace (K13)", "max_abs_err": 0.0,
        "tolerance": "bit-identical (integer lookups)",
        "routes_by_case": k13_routes,
        **time_routes(vk.align_backtrace_pallas, (end_s, adv, li), bt_steps, width_route(S)),
        "warp_device_ms": {p: bt_split["phase_ms"][p] for p in K13_WARP_PHASES},
        "plain_ms": time_ms(lambda: vk.align_backtrace_plain(end_s, adv, li), runs=5,
                            warmup=1),
        "bound_ms": k13_bound, "bound_by": k13_by, "serial_steps": bt_steps,
    }
    return k12, k13


# (name, dtype, (B, T, N, S), L_in, L_out, -inf transitions) for K3-K8.  E
# sits in K3's and K4's shared memory at N=30 and in the fp32 N=200 case,
# in global memory at fp64 N=200, N=300 and N=512; K5's accumulator in
# shared memory up to N=200 fp32, in the (B, N, N) scratch past it.
LATTICE_CASES = (
    ("fp64_small", torch.float64, (4, 40, 12, 9), (9, 40), (1, 9), False),
    ("fp64_degenerate", torch.float64, (7, 40, 12, 9), [1, 40, 2, 3, 17, 0, 41],
     [1, 1, 4, 9, 3, 2, 2], False),
    ("fp64_neg_inf", torch.float64, (4, 40, 12, 9), (9, 40), (1, 9), True),
    ("fp64_n200_global", torch.float64, (3, 30, 200, 20), (20, 30), (1, 20), False),
    ("fp32_neg_inf", torch.float32, (4, 300, N, 20), (150, 300), (5, 20), True),
    ("fp32_n200_smem", torch.float32, (4, 60, 200, 20), (20, 60), (1, 20), False),
    ("fp32_n300_global", torch.float32, (4, 60, 300, 20), (20, 60), (1, 20), False),
    ("fp32_width_cap", torch.float32, (2, 600, 512, 512), (512, 600), (1, 512), False),
    ("fp32_training", torch.float32, (B, T, N, S), (500, 1000), (10, 50), False),
)
# K3's, K4's and K5's warp-route width edges, fp32 and fp64 (from their own
# seeded stream): N = 32, 33, 64, 65 and 128, the last label in lane 31 of
# a lane's last register, so that every label register count (1, 2 or 4)
# runs, with E (fp64 N = 128: 132 KB) in the warp route's shared memory.
FCC_WIDTH_CASES = tuple(
    (f"{'fp32' if dt == torch.float32 else 'fp64'}_n{n}", dt, (3, 200, n, 10), (100, 200),
     (1, 10), False)
    for dt in (torch.float32, torch.float64) for n in (32, 33, 64, 65, 128))
# K6's, K7's and K8's warp-route width edges, fp32 and fp64 (from their own
# seeded stream): S = 32, 33, 64, 65 and 128 slots, the last slot in lane
# 31 of a lane's last register, so that every slot register count (1, 2 or
# 4) runs, with target lengths from S/2 to S so that the last slots are
# live.
FAC_WIDTH_CASES = tuple(
    (f"{'fp32' if dt == torch.float32 else 'fp64'}_s{s}", dt, (3, 200, 12, s), (150, 200),
     (s // 2, s), False)
    for dt in (torch.float32, torch.float64) for s in (32, 33, 64, 65, 128))
# Every output of K3-K8 against its plain version: fp32 covers 1000 serial
# steps summed in another order (K1's bound); fp64 is the same arithmetic
# to rounding.
LATTICE_TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-4, 1e-3)}
# The kernels of K3's, K4's, K5's, K6's, K7's and K8's warp routes, by name,
# in launch order.
K3_WARP_PHASES = ("fcc_fwd_warp_kernel", "fcc_fwd_log_kernel")
K4_WARP_PHASES = ("fcc_beta_warp_kernel", "fcc_beta_log_kernel")
K5_WARP_PHASES = ("fcc_bwd_post_kernel", "fcc_bwd_sums_kernel")
K6_WARP_PHASES = ("fac_alpha_band_kernel", "fac_alpha_warp_kernel", "fac_alpha_fill_kernel")
K7_WARP_PHASES = ("fac_beta_warp_kernel",)
K8_WARP_PHASES = ("fac_bwd_post_kernel", "fac_bwd_sums_kernel")


def check_lattice_kernels(rng, dev, only=None):
    """K3-K8 against their plain versions on the card in every case of
    LATTICE_CASES, K3, K4 and K5 also in FCC_WIDTH_CASES and K6, K7 and K8
    in FAC_WIDTH_CASES; each kernel on each route that takes the case's
    width (labels for K3-K5, slots for K6-K8), the elements without a path
    of ``fp64_degenerate`` on each route too; K6's warp route against its
    own plain version (the blocked algorithm) and the sequential one; K5
    and K8 run on the plain versions' chains, so both versions see the same
    inputs, and twice on each route, which must give the same bits.  Times
    and bounds at the training shape, both routes of each kernel, the
    device time of each kernel of their warp routes (the profile
    ``lattice_warp``), and K6's warp route at each block size it is built
    for, fp32 and fp64 (``block_sweep_ms``).  ``only`` (kernel ids)
    restricts the checks and times to those kernels."""
    from torch_asg_tpu_torch.ops.fac import make_aligned
    from torch_asg_tpu_torch.ops.kernels import fac_kernels as ak
    from torch_asg_tpu_torch.ops.kernels import fcc_kernels as fk
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    names = ("K3", "K4", "K5", "K6", "K7", "K8")
    routed_ids = names
    errs = {k: {} for k in names}
    # the width edges draw from streams of their own, keeping ``rng``'s as it was
    fcc_rng, fac_rng = np.random.default_rng([SEED, 8]), np.random.default_rng([SEED, 9])
    width_rngs = {**{c[0]: fcc_rng for c in FCC_WIDTH_CASES},
                  **{c[0]: fac_rng for c in FAC_WIDTH_CASES}}
    case_kernels = {**{c[0]: ("K3", "K4", "K5") for c in FCC_WIDTH_CASES},
                    **{c[0]: ("K6", "K7", "K8") for c in FAC_WIDTH_CASES}}
    # the width edges first, so that the loop ends on the training shape
    for name, dtype, (b, t, n, s), li_r, lo_r, neg_inf in (FCC_WIDTH_CASES + FAC_WIDTH_CASES
                                                          + LATTICE_CASES):
        case_rng = width_rngs.get(name, rng)
        kernels = case_kernels.get(name, names)
        trans, inputs, targets, li, lo = lattice_case(case_rng, dev, dtype, b, t, n, s, li_r,
                                                      lo_r)
        if neg_inf:
            forbid = torch.as_tensor(case_rng.random((n, n)) < 0.3, device=dev)
            trans = trans.masked_fill(forbid, -np.inf)
        g = torch.as_tensor(case_rng.uniform(0.5, 1.5, size=b), dtype=dtype, device=dev)
        e, c, x, li32 = fk._prepare(trans, inputs, li)
        lat = make_aligned(trans, inputs, targets, li, lo)
        if "K5" in kernels:
            fwd_want = fk.fcc_fwd_plain(e, c, x, li32)
        if "K8" in kernels:
            fac_want = (ak.fac_alpha_plain(lat), ak.fac_beta_plain(lat, li, lo))

        # (kernel id, route or "block"/"cuda" for one-route kernels) ->
        # (kernel, plain)
        runs = {}
        if "K3" in kernels:
            for route in width_routes(n):
                runs[("K3", route)] = (
                    lambda route=route: fk.fcc_fwd_pallas(e, c, x, li32, route=route),
                    lambda: fk.fcc_fwd_plain(e, c, x, li32))
        if "K4" in kernels:
            for route in width_routes(n):
                runs[("K4", route)] = (
                    lambda route=route: (fk.fcc_beta_pallas(e, c, x, li32, route=route),),
                    lambda: (fk.fcc_beta_plain(e, c, x, li32),))
        if "K5" in kernels:
            for route in width_routes(n):
                runs[("K5", route)] = (
                    lambda route=route: fk.fcc_bwd_pallas(e, c, x, li32, *fwd_want, g,
                                                          route=route),
                    lambda: fk.fcc_bwd_plain(e, c, x, li32, *fwd_want, g))
        if "K6" in kernels:
            for route in width_routes(s):
                runs[("K6", route)] = (
                    lambda route=route: (ak.fac_alpha_pallas(lat, route=route),),
                    (lambda: (ak.fac_alpha_blocked_plain(lat, ak.FAC_ALPHA_BLOCK),))
                    if route == "warp" else lambda: (ak.fac_alpha_plain(lat),))
        if "K7" in kernels:
            for route in width_routes(s):
                runs[("K7", route)] = (
                    lambda route=route: (ak.fac_beta_pallas(lat, li, lo, route=route),),
                    lambda: (ak.fac_beta_plain(lat, li, lo),))
        if "K8" in kernels:
            for route in width_routes(s):
                runs[("K8", route)] = (
                    lambda route=route: ak.fac_bwd_pallas(lat, *fac_want, g, route=route),
                    lambda: ak.fac_bwd_plain(lat, *fac_want, g))
        if only is not None:
            runs = {key: run for key, run in runs.items() if key[0] in only}

        rtol, atol = LATTICE_TOL[dtype]
        for (kname, variant), (kernel, plain) in runs.items():
            got, want = kernel(), plain()
            label = f"{kname} {variant} {name}"
            if kname in ("K5", "K8"):
                again = kernel()
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{label}: two runs differ")
            torch.cuda.synchronize()
            for i, (gv, wv) in enumerate(zip(got, want)):
                check(not bool(torch.isnan(gv).any()), f"{label} output {i}: NaN")
                torch.testing.assert_close(gv, wv, rtol=rtol, atol=atol,
                                           msg=lambda m: f"{label} output {i}: {m}")
            err = max(max_err(gv, wv) for gv, wv in zip(got, want))
            errs[kname].setdefault(name, {})[variant] = err
            if (kname, variant) == ("K6", "warp"):
                # the blocked algorithm against the sequential recursion too
                seq = ak.fac_alpha_plain(lat)
                torch.testing.assert_close(got[0], seq, rtol=rtol, atol=atol,
                                           msg=lambda m: f"{label} vs sequential: {m}")
                errs[kname][name]["warp_vs_sequential"] = max_err(got[0], seq)
        if name == "fp64_degenerate":
            # L_in outside [1, T] (elements 5, 6) has no beta; L_out > L_in
            # (elements 2, 3) no aligned path
            def picked(*ids):
                return only is None or any(k in only for k in ids)

            for route in width_routes(n) if picked("K4") else ():
                beta = fk.fcc_beta_pallas(e, c, x, li32, route=route)
                check(bool((beta[:, [5, 6]] == -np.inf).all()),
                      f"K4 {route}: elements without a path must have no beta")
            for route in width_routes(s) if picked("K6") else ():
                # rows t >= L_in, every row of element 5 (L_in = 0)
                dead = torch.arange(t, device=dev)[:, None] >= li[None, :]
                alpha_r = ak.fac_alpha_pallas(lat, route=route)
                check(bool((alpha_r[dead] == -np.inf).all()),
                      f"K6 {route}: rows past L_in must be -inf")
            for route in width_routes(s) if picked("K7") else ():
                fac_beta = ak.fac_beta_pallas(lat, li, lo, route=route)
                check(bool((fac_beta[:, [5, 6]] == -np.inf).all())
                      and bool((fac_beta[0, [2, 3, 5, 6], 0] == -np.inf).all()),
                      f"K7 {route}: elements without a path must have no beta")
            for route in width_routes(n) if picked("K3", "K5") else ():
                alpha_r, beta_r = fk.fcc_fwd_pallas(e, c, x, li32, route=route)
                gi_r, _ = fk.fcc_bwd_pallas(e, c, x, li32, *fwd_want, g, route=route)
                check(bool((beta_r[:, [5, 6]] == -np.inf).all())
                      and bool((alpha_r[:, 5] == -np.inf).all())
                      and bool((gi_r[:, [5, 6]] == 0).all()),
                      f"K3/K5 {route}: elements without a path must have no beta and "
                      "zero posteriors")
            for route in width_routes(s) if picked("K8") else ():
                da_r = ak.fac_bwd_pallas(lat, *fac_want, g, route=route)[0]
                check(bool((da_r[:, [2, 3, 5, 6]] == 0).all()),
                      f"K8 {route}: elements without an aligned path must have zero "
                      "posteriors")
    # timing and bounds at the training shape (the last case)
    check(name == "fp32_training", "the loop must end on the training shape")
    lsum, w = int(li.sum()), 4
    tbn, tbs = T * B * N * w, T * B * S * w
    step = 2 * N * N + 8 * N
    cost = {
        "K3": ((lsum * N + N * N) * w + B * 4 + 2 * tbn, 2 * (lsum - B) * step),
        "K4": ((lsum * N + N * N) * w + B * 4 + tbn, (lsum - B) * step),
        "K5": ((3 * lsum * N + 2 * N * N + B) * w + B * 4 + tbn,
               lsum * (2 * N * N + 10 * N) + B * N * N),
        "K6": ((2 * B * S) * w + 2 * tbs, T * B * S * 8),
        "K7": ((lsum * S + 2 * B * S) * w + 2 * B * 4 + tbs, (lsum - B) * S * 8),
        "K8": ((2 * B * S + B) * w + 4 * tbs + 2 * B * S * w, T * B * S * 14),
    }
    # id -> (stem, the pallas_call line of the TPU kernel it replaces)
    meta = {"K3": ("fcc_fwd", "fcc_kernels.py:126"), "K4": ("fcc_beta", "fcc_kernels.py:202"),
            "K5": ("fcc_bwd", "fcc_kernels.py:284"), "K6": ("fac_alpha", "fac_kernels.py:146"),
            "K7": ("fac_beta", "fac_kernels.py:163"), "K8": ("fac_bwd", "fac_kernels.py:185")}
    rtol, atol = LATTICE_TOL[torch.float32]
    serial = int(li.max()) - 1
    # id -> (wrapper, arguments, serial steps, warp-route kernels, width)
    routed = {
        "K3": (fk.fcc_fwd_pallas, (e, c, x, li32), serial, K3_WARP_PHASES, N),
        "K4": (fk.fcc_beta_pallas, (e, c, x, li32), serial, K4_WARP_PHASES, N),
        "K5": (fk.fcc_bwd_pallas, (e, c, x, li32, *fwd_want, g), int(li.max()),
               K5_WARP_PHASES, N),
        "K6": (ak.fac_alpha_pallas, (lat,), T - 1, K6_WARP_PHASES, S),
        "K7": (ak.fac_beta_pallas, (lat, li, lo), serial, K7_WARP_PHASES, S),
        "K8": (ak.fac_bwd_pallas, (lat, *fac_want, g), T, K8_WARP_PHASES, S),
    }
    # the warp routes' kernels by device time, K3's-K8's in one profile
    split = profile_call("lattice_warp") if any(k in routed for k, _ in runs) else None
    check(split is None or split["complete"],
          f"K3's-K8's warp routes must run their twelve kernels: {split}")
    out = []
    for (kname, variant), (kernel, plain) in runs.items():
        if kname in routed and variant != width_route(routed[kname][4]):
            continue
        bound_ms, bound_by = bound(*cost[kname])
        stem, replaces = meta[kname]
        entry = {
            "name": f"{stem} ({kname})", "wrapper": f"{stem}_pallas",
            "source": f"torch_asg_tpu_torch/ops/kernels/csrc/{stem[:3]}.cu",
            "replaces": f"torch_asg_tpu/ops/pallas/{replaces}",
            "max_abs_err_by_case": errs[kname],
            "tolerance": (f"fp32 rtol {rtol:g} atol {atol:g} (1000 serial steps, other sum "
                          "order); fp64 1e-10" + ("; two runs bit-identical"
                                                  if kname in ("K5", "K8") else "")),
            "plain_ms": time_ms(plain, runs=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "serial_steps": T - 1 if kname in ("K6", "K8") else serial,
        }
        wrapper, args, steps, phases, width = routed[kname]
        entry.update(time_routes(wrapper, args, steps, width_route(width)))
        entry["max_abs_err"] = errs[kname]["fp32_training"][entry["route_auto"]]
        entry["warp_device_ms"] = {p: split["phase_ms"][p] for p in phases}
        out.append(entry)
    return out


def lattice_route_launches(reset=False):
    """K3's-K8's launches by route, {"<wrapper>.<route>": n}; with ``reset``
    the counts are set to 0 first."""
    from torch_asg_tpu_torch.ops.kernels import fac_kernels as ak
    from torch_asg_tpu_torch.ops.kernels import fcc_kernels as fk
    from torch_asg_tpu_torch.ops.kernels.common import ROUTES

    out = {}
    for wrapper in (fk.fcc_fwd_pallas, fk.fcc_beta_pallas, fk.fcc_bwd_pallas,
                    ak.fac_alpha_pallas, ak.fac_beta_pallas, ak.fac_bwd_pallas):
        for route in ROUTES:
            if reset:
                setattr(wrapper, f"launches_{route}", 0)
            out[f"{wrapper.__name__}.{route}"] = getattr(wrapper, f"launches_{route}")
    return out


def check_lattice_auto_route(**launches):
    """Since the last reset, each wrapper named in ``launches`` (e.g.
    ``fcc_fwd_pallas=5``) launched that many times and the other routed
    wrappers of K3-K8 never, every time through the route 'auto' takes (at
    N labels for K3, K4 and K5, at S slots for K6, K7 and K8)."""
    from torch_asg_tpu_torch.ops.kernels.common import width_route

    got = lattice_route_launches()
    want = dict.fromkeys(got, 0)
    for wrapper, count in launches.items():
        want[f"{wrapper}.{width_route(N if wrapper.startswith('fcc') else S)}"] = count
    check(got == want,
          f"every K3-K8 launch must take the route 'auto' takes: {got}")
    return got


def lattice_counters():
    """The launch counters of K3-K8's wrappers."""
    from torch_asg_tpu_torch.ops.kernels import fac_kernels, fcc_kernels

    return (fcc_kernels.fcc_fwd_pallas, fcc_kernels.fcc_beta_pallas,
            fcc_kernels.fcc_bwd_pallas, fac_kernels.fac_alpha_pallas,
            fac_kernels.fac_beta_pallas, fac_kernels.fac_bwd_pallas)


def check_grads_vs_scan(rng, dev):
    """asg_loss gradients through the fused tier (K1 with stores -> K2 ->
    scatter_to_full) and through the per-lattice tier (K3, K6, K7 -> K5,
    K8 -> scatter_to_full) against the scan tier's autograd gradients,
    fp64, at the training shape (B=64, T=1000, N=30, S=50, ragged
    lengths)."""
    from torch_asg_tpu_torch import asg_loss
    from torch_asg_tpu_torch.ops.kernels.asg_kernels import _bwd_kernel, _fwd_store_kernel

    trans, inputs, targets, li, lo = lattice_case(rng, dev, torch.float64, B, T, N, S,
                                                  (T // 2, T), (10, S))
    grads, losses = {}, {}
    counters = (_fwd_store_kernel, _bwd_kernel, *lattice_counters())
    before = {c.__name__: c.launches for c in counters}
    for impl in ("fused", "pallas", "scan"):
        tr = trans.clone().requires_grad_(True)
        em = inputs.clone().requires_grad_(True)
        loss = asg_loss(tr, em, targets, li, lo, impl=impl)
        grads[impl] = torch.autograd.grad(loss, (tr, em))
        losses[impl] = loss.detach()
    launched = {c.__name__: c.launches - before[c.__name__] for c in counters}
    want = dict.fromkeys(before, 1)
    want["fcc_beta_pallas"] = 0
    check(launched == want, f"the fused and per-lattice tiers' launches: {launched}")
    errs = {}
    for tier in ("fused", "pallas"):
        torch.testing.assert_close(losses[tier], losses["scan"], rtol=1e-9, atol=0)
        for label, g, w in zip(("transition", "emissions"), grads[tier], grads["scan"]):
            assert_near(f"{tier} vs scan grad {label}", g, w, 1e-8, 1e-10)
            errs[f"{tier}_{label}"] = max_err(g, w)
    emit({"phase": "grads", "dtype": "float64", "shape": [B, T, N, S],
          "tolerance": "rtol 1e-8, atol 1e-10 x max|scan gradient|",
          "max_abs_err_vs_scan": errs, "loss": float(losses["fused"]),
          "launches": launched})


def flax_layout_params(rng, cfg):
    """Random Wav2Letter weights in the Flax layout, zero biases.  Kernels are
    normal with variance 2 / fan_in, so activations keep their scale through
    the ReLU stack and the decoded paths change label as real ones do."""
    params = {}
    widths = [(FEATURES, cfg["channels"], cfg["frontend_kernel"])]
    widths += [(cfg["channels"], cfg["channels"], cfg["kernel"])] * cfg["depth"]
    widths += [(cfg["channels"], cfg["head_channels"], cfg["kernel"])]
    for i, (cin, cout, k) in enumerate(widths):
        kernel = rng.normal(size=(k, cin, cout)) * np.sqrt(2.0 / (k * cin))
        params[f"ConvBlock_{i}"] = {"Conv_0": {"kernel": kernel.astype(np.float32),
                                               "bias": np.zeros(cout, np.float32)}}
    params["Dense_0"] = {
        "kernel": (rng.normal(size=(cfg["head_channels"], cfg["num_labels"]))
                   * np.sqrt(2.0 / cfg["head_channels"])).astype(np.float32),
        "bias": np.zeros(cfg["num_labels"], np.float32)}
    return params


def serve(rng, dev, counters):
    from torch_asg_tpu_torch import asg_loss, asg_scores, viterbi_decode
    from torch_asg_tpu_torch.convert import transition_from_numpy
    from torch_asg_tpu_torch.runtime import collapse_path

    model = letter_model(rng, dev).eval()
    trans = transition_from_numpy(rng.normal(size=(N, N)) * 0.5, device=dev,
                                  dtype=torch.float32)
    requests = []
    for _ in range(3):
        feat_lengths = rng.integers(1000, 2001, size=B)
        feats = rng.normal(size=(B, 2000, FEATURES)).astype(np.float32)
        lo = rng.integers(10, S + 1, size=B)
        targets = rng.integers(0, ALPHABET, size=(B, S))
        requests.append([torch.as_tensor(x, device=dev) for x in
                         (feats, feat_lengths, targets.astype(np.int32), lo.astype(np.int32))])
    torch.cuda.synchronize()

    def answer(feats, feat_lengths, targets, lo, sync=lambda: None, native=True):
        """One request; ``sync`` runs after each stage (a no-op when timing
        the whole request); ``native``: collapse_path's arm."""
        marks = [time.perf_counter()]

        def mark():
            sync()
            marks.append(time.perf_counter())

        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)
            mark()
            dec = viterbi_decode(trans, em, li)
            mark()
            paths = dec.paths.cpu().numpy()
            hyps = [collapse_path(paths[:, b], ALPHABET, MAX_REPS, use_native=native)
                    for b in range(B)]
            mark()
            full, aligned = asg_scores(trans, em, targets, li, lo)
            mark()
            loss = asg_loss(trans, em, targets, li, lo, reduction="none")
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        stage_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        return (em, li, targets, lo, dec, hyps, full, aligned, loss), stage_ms

    answer(*requests[0])  # warm-up: library loads, cuDNN set-up
    for c in counters:
        c.launches = 0
    route_launches(reset=True)
    latencies, outs = [], []
    for req in requests:
        out, stage_ms = answer(*req)
        latencies.append(sum(stage_ms))
        outs.append(out)
    launches = {c.__name__: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"serving path never launched {name}")
    routes_seen = check_auto_route(launches["asg_scores_fused"], 0, 0,
                                   launches["viterbi_forward_pallas"])
    # where a request's time goes: the first request again, synchronised
    # after each stage (outside the counted run), with each collapse arm
    stage_names = ("encoder", "viterbi_decode", "paths_to_host_and_collapse", "asg_scores",
                   "asg_loss")
    stages = dict(zip(stage_names, answer(*requests[0], sync=torch.cuda.synchronize)[1]))
    stages_numpy = dict(zip(stage_names, answer(*requests[0], sync=torch.cuda.synchronize,
                                                native=False)[1]))
    # the native hypotheses against the NumPy arm's, on the same paths
    first_paths = outs[0][4].paths.cpu().numpy()
    hyps_numpy = [collapse_path(first_paths[:, b], ALPHABET, MAX_REPS, use_native=False)
                  for b in range(B)]
    check(all(np.array_equal(h, w) and h.dtype == w.dtype
              for h, w in zip(outs[0][5], hyps_numpy)),
          "native hypotheses differ from the NumPy arm's")
    # one asg_scores call alone: its CUDA-event median and the device's share
    em, li, targets, lo = outs[0][:4]

    def scores():
        with torch.no_grad():
            asg_scores(trans, em, targets, li, lo)

    scores_ms = time_ms(scores)
    scores_profile = profile_call("serve_scores")
    # one viterbi_decode call alone, profiled: the decode stage's device time
    decode_profile = profile_call("serve_decode")

    for em, li, targets, lo, dec, hyps, full, aligned, loss in outs:
        check(tuple(em.shape) == (T, B, N), f"emissions shape {tuple(em.shape)}")
        check(bool(((li >= 500) & (li <= T)).all()), "emission lengths")
        for x in (full, aligned, loss, dec.scores):
            check(bool(torch.isfinite(x).all()), "non-finite serving output")
        check(bool((full >= aligned - 1e-3).all()), "full score below aligned score")
        check(all(len(h) > 0 for h in hyps), "empty hypothesis")
    # the first request against the log-domain oracle tiers on the card
    em, li, targets, lo, dec, _, full, aligned, loss = outs[0]
    with torch.no_grad():
        ref_dec = viterbi_decode(trans, em, li, impl="xla")
        ref_full, ref_aligned = asg_scores(trans, em, targets, li, lo, impl="scan")
    check(torch.equal(dec.paths, ref_dec.paths), "kernel paths differ from the xla tier")
    torch.testing.assert_close(dec.scores, ref_dec.scores, rtol=0, atol=0)
    torch.testing.assert_close(full, ref_full, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(aligned, ref_aligned, rtol=1e-4, atol=1e-3)
    emit({"phase": "serve", "card": torch.cuda.get_device_name(0),
          "requests": 3, "batch": B, "frames": T,
          "latency_ms": latencies, "median_latency_ms": statistics.median(latencies),
          "launches": launches, "route_launches": routes_seen,
          "stage_ms_first_request": stages,
          "stage_ms_first_request_numpy_collapse": stages_numpy,
          "native_hypotheses_equal_numpy": True, "asg_scores_ms": scores_ms,
          "asg_scores_profile": scores_profile, "viterbi_decode_profile": decode_profile,
          "max_abs_err_scores_vs_scan": max(float((full - ref_full).abs().max()),
                                            float((aligned - ref_aligned).abs().max())),
          "mean_loss": float(loss.mean()),
          "hypothesis_lengths_first_request": [len(h) for h in outs[0][5][:8]]})
    return launches


def train_batch(rng, longest=None):
    """Random utterances (64 features, 1000-2000 frames, each with its own
    offset and scale) and label sequences (10-50 letters of ALPHABET);
    ``longest``, when given, is the first utterance's length."""
    utts = []
    lengths = rng.integers(1000, 2001, size=B)
    if longest is not None:
        lengths[0] = longest
    for length in lengths:
        loc, scale = rng.normal(size=FEATURES), rng.uniform(0.5, 2.0, size=FEATURES)
        utts.append((rng.normal(size=(int(length), FEATURES)) * scale + loc)
                    .astype(np.float32))
    labels = [rng.integers(0, ALPHABET, size=int(rng.integers(10, 51))) for _ in range(B)]
    return utts, labels


def host_batch(utts, labels, use_native=True):
    """The host data path of examples/train_asg.py with the port's own
    modules: cmvn -> pack_frames -> encode_targets, as NumPy arrays."""
    from torch_asg_tpu_torch.runtime import cmvn, encode_targets, pack_frames

    feats, feat_lengths = pack_frames(cmvn(utts, use_native=use_native),
                                      use_native=use_native)
    targets, target_lengths = encode_targets(labels, ALPHABET, MAX_REPS,
                                             use_native=use_native)
    return {"features": np.ascontiguousarray(feats.transpose(1, 0, 2)),
            "feature_lengths": feat_lengths, "targets": targets,
            "target_lengths": target_lengths}


def prepare_batch(utts, labels, dev):
    """``host_batch`` (native), then to the card."""
    return {k: torch.as_tensor(v).to(dev) for k, v in host_batch(utts, labels).items()}


# the native arm's CMVN against the NumPy arm's (rtol, atol): float64
# statistics in both, the last float32 rounding apart
CMVN_TOL = (1e-5, 1e-5)


def host_prep_arms(utts, labels, runs=3):
    """Host prep of one batch with each arm: {arm: median ms}; the batches
    must agree, features within CMVN_TOL and the rest exactly."""
    batches, times = {}, {}
    for arm, native in (("numpy", False), ("native", True)):
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            batches[arm] = host_batch(utts, labels, use_native=native)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[arm] = statistics.median(ms)
    for key, want in batches["numpy"].items():
        got = batches["native"][key]
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"native {key} {got.shape} {got.dtype} against {want.shape} {want.dtype}")
        if key == "features":
            check(np.allclose(got, want, rtol=CMVN_TOL[0], atol=CMVN_TOL[1]),
                  f"native features differ by {np.abs(got - want).max()}")
        else:
            check(np.array_equal(got, want), f"native {key} differ from the NumPy arm's")
    return times, float(np.abs(batches["native"]["features"]
                               - batches["numpy"]["features"]).max())


def train(rng, dev):
    """The full-width Wav2Letter trains on one fixed batch through the port's
    entry points: one warm-up step, then 5 timed steps, each ending in a
    device synchronise."""
    from torch_asg_tpu_torch import asg_loss
    from torch_asg_tpu_torch.asg import _spread_guard
    from torch_asg_tpu_torch.models import create_train_state, loss_fn, make_train_step
    from torch_asg_tpu_torch.ops.kernels.asg_kernels import (_bwd_kernel,
                                                              _fwd_store_kernel,
                                                              asg_scores_fused)

    model = letter_model(rng, dev)
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer)
    utts, labels = train_batch(rng)
    batch = prepare_batch(utts, labels, dev)
    li = model.output_length(batch["feature_lengths"]).to(torch.int32)
    check(int(batch["targets"].shape[1]) <= S, "encoded targets wider than S")
    host_prep_ms, features_err = host_prep_arms(utts, labels)

    # the first step's gradients, fused tier against the scan tier (fp32)
    with torch.no_grad():
        em0 = model(batch["features"])
    grads = {}
    for impl in ("auto", "scan"):
        tr = state.transition.detach().clone().requires_grad_(True)
        em = em0.clone().requires_grad_(True)
        loss = asg_loss(tr, em, batch["targets"], li, batch["target_lengths"], impl=impl)
        grads[impl] = torch.autograd.grad(loss, (tr, em))
    grad_errs = {}
    for label, g, w in zip(("transition", "emissions"), grads["auto"], grads["scan"]):
        check(bool(torch.isfinite(g).all()), f"non-finite {label} gradient")
        assert_near(f"train grad {label} vs scan", g, w, 1e-3, 1e-4)
        grad_errs[label] = max_err(g, w)

    def finite_grads():
        return all(bool(torch.isfinite(p.grad).all())
                   for p in (*model.parameters(), state.transition))

    state, _ = step(state, batch)  # warm-up: cuDNN set-up
    torch.cuda.synchronize()
    counters = (asg_scores_fused, _fwd_store_kernel, _bwd_kernel)
    for c in counters:
        c.launches = 0
    route_launches(reset=True)
    losses, latencies = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        check(finite_grads(), "non-finite gradient in a training step")
    launches = {"asg_scores_fused": asg_scores_fused.launches,
                "_fwd_store_kernel": _fwd_store_kernel.launches,
                "_bwd_kernel": _bwd_kernel.launches}
    check(launches["_fwd_store_kernel"] == 5 and launches["_bwd_kernel"] == 5,
          f"K1 with stores and K2 must launch once a step: {launches}")
    check(launches["asg_scores_fused"] == 0,
          f"the score-only K1 must not launch in a training step: {launches}")
    routes_seen = check_auto_route(0, 5, 5)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    with torch.no_grad():
        loss_after = float(loss_fn(model, state, batch))
    check(loss_after < losses[0], f"loss did not fall: {losses[0]} -> {loss_after}")
    median_ms = statistics.median(latencies)

    # one more step, synchronised after each stage
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    staged = prepare_batch(utts, labels, dev)
    mark()
    state.optimizer.zero_grad(set_to_none=True)
    em = model(staged["features"])
    mark()
    loss = asg_loss(state.transition, em, staged["targets"],
                    model.output_length(staged["feature_lengths"]).to(torch.int32),
                    staged["target_lengths"])
    mark()
    loss.backward()
    mark()
    state.optimizer.step()
    mark()
    stages = dict(zip(("host_prep", "encoder_forward", "asg_loss_forward", "backward",
                       "optimizer_step"),
                      [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]))

    # the criterion alone: asg_loss forward + backward on fixed emissions
    em_fixed = em0.detach().clone().requires_grad_(True)
    tr_fixed = state.transition.detach().clone().requires_grad_(True)

    def criterion():
        out = asg_loss(tr_fixed, em_fixed, batch["targets"], li, batch["target_lengths"])
        torch.autograd.grad(out, (tr_fixed, em_fixed))

    criterion_ms = time_ms(criterion)
    profiled = profile_call("train_criterion")
    # the spread guard alone: one (N, N) reduction and one host sync a call
    guard_ms = time_ms(lambda: _spread_guard(tr_fixed.detach(), "auto", 1.0, True))
    frames = int(li.sum())
    emit({"phase": "train", "card": torch.cuda.get_device_name(0), "batch": B,
          "frames_max": int(li.max()), "frames_sum": frames,
          "steps": 5, "step_ms": latencies, "median_step_ms": median_ms,
          "frames_per_s": frames / (median_ms * 1e-3), "losses": losses,
          "loss_after": loss_after, "launches": launches,
          "route_launches": routes_seen,
          "grad_tolerance": "rtol 1e-3, atol 1e-4 x max|scan gradient| (fp32)",
          "max_abs_err_grads_vs_scan": grad_errs, "stage_ms": stages,
          "criterion_fwd_bwd_ms": criterion_ms, "spread_guard_ms": guard_ms,
          "criterion_frames_per_s": frames / (criterion_ms * 1e-3),
          "criterion_profile": profiled, "host_prep_ms": host_prep_ms,
          "cmvn_tolerance": CMVN_TOL, "max_abs_err_native_features": features_err})
    train_prefetch(np.random.default_rng([SEED, 13]), dev, state, step)
    return {k: launches[k] for k in ("_fwd_store_kernel", "_bwd_kernel")}, (utts, labels)


PREFETCH_BATCHES = 12


def prefetch_batches(rng):
    """PREFETCH_BATCHES distinct full-width batches (utterances and labels),
    each with a longest utterance of 2000 frames, so that every batch has one
    shape and the encoder's convolutions plan it once."""
    return [train_batch(rng, longest=2000) for _ in range(PREFETCH_BATCHES)]


def prefetched(raw, dev, prep_ms=None):
    """The batches of ``raw`` through ``device_prefetch(depth=2)``: native host
    prep on a worker thread, the copy on a side stream; each batch's host
    prep time on the worker is appended to ``prep_ms`` when given."""
    from torch_asg_tpu_torch.runtime import device_prefetch

    def prepare(item):
        t0 = time.perf_counter()
        out = host_batch(*item)
        if prep_ms is not None:
            prep_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return device_prefetch(raw, prepare, depth=2, device=dev)


def run_loop(state, step, make_batches):
    """One step on each batch that ``make_batches()`` yields, timed from
    before that call to a device synchronise after the last step: (the
    batches, the losses, the wall time in s, the ms until the first batch
    was in hand: the part of a prefetched loop that nothing overlaps)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = make_batches()
    seen, losses = [], []
    try:
        for batch in batches:
            if not seen:
                first_ms = (time.perf_counter() - t0) * 1e3
            seen.append(batch)
            state, loss = step(state, batch)
            losses.append(loss)
    finally:
        if hasattr(batches, "close"):
            batches.close()
    torch.cuda.synchronize()
    return seen, [float(x) for x in losses], time.perf_counter() - t0, first_ms


def train_prefetch(rng, dev, state, step):
    """PREFETCH_BATCHES distinct full-width batches, trained on from one
    saved model and optimizer state, in the same order: serially (prepare,
    copy, step), through ``device_prefetch``, and from the serial loop's
    batches already on the card (the step's own pace).  The prefetcher
    changes when a batch is copied, not what is copied: each of its batches
    must equal the serial loop's, tensor for tensor."""
    raw = prefetch_batches(rng)
    state, _ = step(state, prepare_batch(*raw[0], dev))  # warm-up: the batches' shape
    saved = (copy.deepcopy(state.model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()), state.transition.detach().clone())

    def restore():
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(copy.deepcopy(saved[1]))
        with torch.no_grad():
            state.transition.copy_(saved[2])

    runs = {}
    restore()
    runs["serial"] = run_loop(state, step, lambda: (prepare_batch(u, lab, dev)
                                                    for u, lab in raw))
    restore()
    worker_prep_ms = []
    runs["prefetched"] = run_loop(state, step, lambda: prefetched(raw, dev, worker_prep_ms))
    restore()
    runs["resident"] = run_loop(state, step, lambda: iter(runs["serial"][0]))
    check(len(runs["prefetched"][0]) == PREFETCH_BATCHES, "the prefetcher lost a batch")
    for i, (got, want) in enumerate(zip(runs["prefetched"][0], runs["serial"][0])):
        for key in want:
            check(got[key].device == want[key].device and got[key].dtype == want[key].dtype
                  and torch.equal(got[key], want[key]),
                  f"prefetched batch {i}'s {key} differs from the serial loop's")
    for name, (_, losses, _, _) in runs.items():
        check(all(np.isfinite(losses)), f"non-finite loss in the {name} loop: {losses}")
    profiled = profile_call("train_prefetch")
    emit({"phase": "train_prefetch", "card": torch.cuda.get_device_name(0),
          "batches": PREFETCH_BATCHES, "batch": B, "depth": 2,
          **{f"{name}_steps_per_s": PREFETCH_BATCHES / wall
             for name, (_, _, wall, _) in runs.items()},
          **{f"{name}_first_batch_ms": first for name, (_, _, _, first) in runs.items()},
          **{f"{name}_losses": losses for name, (_, losses, _, _) in runs.items()},
          "worker_host_prep_ms": worker_prep_ms,
          "batches_equal_serial": True, "prefetched_loop_profile": profiled})


def device_profile(fn, names=()):
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    sum of its kernels' own times, ms), the number of kernels, the five
    kernels that took longest in all ([name cut to 80 characters, ms]), and
    for each name in ``names`` the time (``phase_ms``) and the number
    (``phase_launches``) of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "kernels": sum(e.count for e in kernels),
        "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3] for e in top],
        "phase_ms": {p: sum(e.self_device_time_total for e in kernels if p in e.key) / 1e3
                     for p in names},
        "phase_launches": {p: sum(e.count for e in kernels if p in e.key) for p in names},
    }


# The profiles of single calls, by name, each with the port's kernels that
# one call launches once each.  ``profile_call`` takes each in a process of
# its own, as that process's first profiler session: sessions that came
# later in a long process lost kernel records (scripts/fcc_diag.py
# --profiler).
PROFILES = {
    "k2_warp": K2_WARP_PHASES,
    "lattice_warp": (K3_WARP_PHASES + K4_WARP_PHASES + K5_WARP_PHASES + K6_WARP_PHASES
                     + K7_WARP_PHASES + K8_WARP_PHASES),
    "k10_warp": K10_WARP_PHASES,
    "k11_warp": K11_WARP_PHASES,
    "k12_warp": K12_WARP_PHASES,
    "k13_warp": K13_WARP_PHASES,
    "serve_scores": ("asg_fwd_warp_kernel",),
    "serve_decode": K10_WARP_PHASES + K11_WARP_PHASES,
    "train_criterion": ("asg_fwd_warp_kernel",) + K2_WARP_PHASES,
    "wordpiece_criterion": ("row_max_kernel", "dual_init_kernel"),
    "pallas_criterion": (K3_WARP_PHASES + K5_WARP_PHASES + K6_WARP_PHASES
                         + K7_WARP_PHASES + K8_WARP_PHASES),
    "pallas_scores": K4_WARP_PHASES + K7_WARP_PHASES,
    "posterior_request": K3_WARP_PHASES + K5_WARP_PHASES,
    # plain PyTorch: no kernel of the port
    "train_prefetch": (),
    "serve_nbest": (),
    "stream_chunk": (),
}
PROFILE_TRIES = 3


def profile_call(name, root=None):
    """Profile ``name`` (a key of PROFILES) in a new process, ``python3
    chip_smoke.py --profile NAME``: ``device_profile``'s reading of one
    call, the call's CUDA-event median (``call_ms``) and its idle share,
    1 - busy / call_ms.  A profile that does not show each kernel PROFILES
    names exactly once is short: it is taken again in another new process,
    up to PROFILE_TRIES times, and if the last is short too, ``complete``
    is False and it gives no idle share.  ``root``: the checkout whose port
    the new process imports, for timing two checkouts with one instrument
    (``scripts/ab_serve_train.py``); its kernels go unchecked (``complete``
    None)."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--profile", name]
    if root is not None:
        cmd += ["--root", str(Path(root).resolve())]
    for attempt in range(1, PROFILE_TRIES + 1):
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        check(run.returncode == 0,
              f"profile {name} failed:\n{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
        out = json.loads(run.stdout.strip().splitlines()[-1])
        out["attempts"] = attempt
        if out["complete"] is not False:
            break
    return out


def profile_target(name, dev):
    """The call that profile ``name`` takes, at the shape its phase gives
    it, on inputs drawn from a seed of its own: (the call, the runs its
    CUDA-event median takes)."""
    from torch_asg_tpu_torch import asg_loss, asg_scores, posterior_decode, viterbi_decode
    from torch_asg_tpu_torch.convert import transition_from_numpy
    from torch_asg_tpu_torch.runtime import collapse_path

    rng = np.random.default_rng([SEED, 90])
    if name == "k10_warp":
        # the kernel's serving-shape case
        from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk

        trans, inputs, _, li, _ = lattice_case(rng, dev, torch.float32, B, T, N, 1, (500, T),
                                               [1] * B)
        return (lambda: vk.viterbi_forward_pallas(trans, inputs, li, route="warp")), RUNS
    if name == "k11_warp":
        # the kernel's serving-shape case: K10's backpointers and final labels
        from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk

        trans, inputs, _, li, _ = lattice_case(rng, dev, torch.float32, B, T, N, 1, (500, T),
                                               [1] * B)
        d_end, bp = vk.viterbi_forward_pallas(trans, inputs, li)
        final = vk.argmax_first(d_end, dim=1)[1]
        return (lambda: vk.viterbi_backtrace_pallas(final, bp, li, route="warp")), RUNS
    if name in ("k12_warp", "k13_warp"):
        # the kernels' serving-shape case; K13 on K12's advance bits
        from torch_asg_tpu_torch.ops.fac import make_aligned
        from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk

        trans, inputs, targets, li, lo = lattice_case(rng, dev, torch.float32, B, T, N, S,
                                                      (T // 2, T), (10, S))
        lat = make_aligned(trans, inputs, targets, li, lo)
        if name == "k12_warp":
            return (lambda: vk.align_forward_pallas(lat, li, route="warp")), RUNS
        adv = vk.align_forward_pallas(lat, li)[1]
        end_s = (lo - 1).to(torch.int32)
        return (lambda: vk.align_backtrace_pallas(end_s, adv, li, route="warp")), RUNS
    if name in ("k2_warp", "lattice_warp"):
        # the kernels' training-shape case
        case = lattice_case(rng, dev, torch.float32, B, T, N, S, (500, 1000), (10, S))
        g = torch.as_tensor(rng.uniform(0.5, 1.5, size=B), dtype=torch.float32, device=dev)
        if name == "k2_warp":
            from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak

            args = k1_args(case)
            pb, qb = ak._fwd_store_kernel(*args, route="warp")[:2]
            bargs = args[:6] + (pb, qb, g, -g)
            return (lambda: ak._bwd_kernel(*bargs, route="warp")), RUNS
        from torch_asg_tpu_torch.ops.fac import make_aligned
        from torch_asg_tpu_torch.ops.kernels import fac_kernels as ak
        from torch_asg_tpu_torch.ops.kernels import fcc_kernels as fk

        trans, inputs, targets, li, lo = case
        args = fk._prepare(trans, inputs, li)
        lat = make_aligned(trans, inputs, targets, li, lo)
        fac_chains = (ak.fac_alpha_pallas(lat), ak.fac_beta_pallas(lat, li, lo))

        def warp_routes():
            alpha, beta = fk.fcc_fwd_pallas(*args, route="warp")
            fk.fcc_beta_pallas(*args, route="warp")
            fk.fcc_bwd_pallas(*args, alpha, beta, g, route="warp")
            ak.fac_alpha_pallas(lat, route="warp")
            ak.fac_beta_pallas(lat, li, lo, route="warp")
            ak.fac_bwd_pallas(lat, *fac_chains, g, route="warp")

        return warp_routes, RUNS
    if name == "train_prefetch":
        # train_prefetch's prefetched loop over batches of its shape
        from torch_asg_tpu_torch.models import create_train_state, make_train_step

        model = letter_model(rng, dev)
        state = create_train_state(model)
        step = make_train_step(model, state.optimizer)
        raw = prefetch_batches(rng)
        return (lambda: run_loop(state, step, lambda: prefetched(raw, dev))), 3
    if name.endswith("criterion") or name == "pallas_scores":
        # asg_loss forward + backward on fixed emissions, as the training
        # phases time it; or one score-only call through the per-lattice
        # tier on them
        if name == "wordpiece_criterion":
            n, impl, runs = WP_N, "auto", 10
            model, batch = letter_model(rng, dev, WP_N), wordpiece_batch(rng, dev)
        else:
            n, impl, runs = N, "pallas" if name == "pallas_criterion" else "auto", RUNS
            model = letter_model(rng, dev)
            batch = prepare_batch(*train_batch(rng), dev)
        li = model.output_length(batch["feature_lengths"]).to(torch.int32)
        with torch.no_grad():
            em = model(batch["features"]).requires_grad_(True)
        # the transition a training run starts from (create_train_state)
        tr = torch.zeros((n, n), device=dev, requires_grad=True)
        if name == "pallas_scores":
            def scores():
                with torch.no_grad():
                    asg_scores(tr, em, batch["targets"], li, batch["target_lengths"],
                               impl="pallas")

            return scores, runs

        def criterion():
            out = asg_loss(tr, em, batch["targets"], li, batch["target_lengths"], impl=impl)
            torch.autograd.grad(out, (tr, em))

        return criterion, runs
    if name == "stream_chunk":
        # one streaming chunk of 100 frames at the serving width from a fresh
        # state: the scores with their read-out, and the best path
        import torch_asg_tpu_torch as pt

        chunk = torch.as_tensor(rng.normal(size=(100, B, N)).astype(np.float32), device=dev)
        trans = torch.as_tensor((rng.normal(size=(N, N)) * 0.5).astype(np.float32),
                                device=dev)
        targets = torch.as_tensor(rng.integers(0, ALPHABET, size=(B, S)).astype(np.int32),
                                  device=dev)
        lo = torch.as_tensor(rng.integers(10, S + 1, size=B).astype(np.int32), device=dev)
        pre = pt.streaming_targets(trans, targets, N, lo)
        st, vst = pt.streaming_init(B, N, S, device=dev), pt.streaming_viterbi_init(B, N,
                                                                                     device=dev)

        def chunk_update():
            with torch.no_grad():
                pt.streaming_scores(pt.streaming_update(trans, st, chunk, stream_targets=pre),
                                    lo)
                pt.streaming_viterbi_update(trans, vst, chunk)

        return chunk_update, 5
    # a serving request's inputs, as ``serve`` and ``serve_posterior`` draw them
    model = letter_model(rng, dev).eval()
    trans = transition_from_numpy(rng.normal(size=(N, N)) * 0.5, device=dev,
                                  dtype=torch.float32)
    feat_lengths = torch.as_tensor(rng.integers(1000, 2001, size=B), device=dev)
    feats = torch.as_tensor(rng.normal(size=(B, 2000, FEATURES)).astype(np.float32),
                            device=dev)
    if name == "serve_nbest":
        from torch_asg_tpu_torch import viterbi_nbest

        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)
        return (lambda: viterbi_nbest(trans, em, NBEST_K, li)), 5
    if name == "serve_decode":
        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)

        def decode():
            with torch.no_grad():
                viterbi_decode(trans, em, li)

        return decode, RUNS
    if name == "serve_scores":
        lo = torch.as_tensor(rng.integers(10, S + 1, size=B).astype(np.int32), device=dev)
        targets = torch.as_tensor(rng.integers(0, ALPHABET, size=(B, S)).astype(np.int32),
                                  device=dev)
        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)

        def scores():
            with torch.no_grad():
                asg_scores(trans, em, targets, li, lo)

        return scores, RUNS
    check(name == "posterior_request", f"no profile named {name!r}")

    def request():
        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)
            paths = posterior_decode(trans, em, li).paths.cpu().numpy()
            for b in range(B):
                collapse_path(paths[:, b], ALPHABET, MAX_REPS, use_native=True)
        torch.cuda.synchronize()

    return request, 5


def profile_main(argv):
    """``chip_smoke.py --profile NAME [--root DIR]``: print ``profile_call``'s
    reading of one profile, taken as this process's first profiler
    session."""
    name = argv[argv.index("--profile") + 1]
    checked = "--root" not in argv
    if not checked:
        sys.path.insert(0, argv[argv.index("--root") + 1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, runs = profile_target(name, torch.device("cuda", 0))
    call_ms = time_ms(fn, runs=runs)
    out = device_profile(fn, PROFILES[name])
    complete = (all(n == 1 for n in out["phase_launches"].values()) if checked else None)
    emit({"profile": name, **out, "call_ms": call_ms, "complete": complete,
          "idle_share": (None if complete is False
                         else 1.0 - out["device_busy_ms"] / call_ms)})
    return 0


def wordpiece_batch(rng, dev):
    """8 utterances of 150-200 frames, the first 200 so that the emissions
    span T = 100 frames (each with its own offset and scale), through cmvn ->
    pack_frames, and 5-10 wordpiece ids each in [0, N)."""
    from torch_asg_tpu_torch.runtime import cmvn, pack_frames

    lengths = rng.integers(2 * WP_T - 50, 2 * WP_T + 1, size=WP_B)
    lengths[0] = 2 * WP_T
    utts = []
    for length in lengths:
        loc, scale = rng.normal(size=FEATURES), rng.uniform(0.5, 2.0, size=FEATURES)
        utts.append((rng.normal(size=(int(length), FEATURES)) * scale + loc)
                    .astype(np.float32))
    feats, feat_lengths = pack_frames(cmvn(utts, use_native=True), use_native=True)
    target_lengths = rng.integers(WP_S // 2, WP_S + 1, size=WP_B).astype(np.int32)
    targets = rng.integers(0, WP_N, size=(WP_B, WP_S)).astype(np.int32)
    host = {"features": np.ascontiguousarray(feats.transpose(1, 0, 2)),
            "feature_lengths": feat_lengths, "targets": targets,
            "target_lengths": target_lengths}
    return {k: torch.as_tensor(v).to(dev) for k, v in host.items()}


def train_wordpiece(rng, dev):
    """The full-width Wav2Letter with a 10,000-wordpiece head trains on one
    fixed batch through the port's entry points ('auto' runs the matmul
    tier): one warm-up step, then 5 timed steps, each ending in a device
    synchronise."""
    from torch_asg_tpu_torch import asg_loss, asg_scores
    from torch_asg_tpu_torch.models import create_train_state, loss_fn, make_train_step
    from torch_asg_tpu_torch.ops.fcc import force_dual_streams
    from torch_asg_tpu_torch.ops.kernels.asg_kernels import (_bwd_kernel,
                                                              _fwd_store_kernel,
                                                              asg_scores_fused)
    from torch_asg_tpu_torch.ops.kernels.bigvocab_kernels import fcc_dual_streams

    model = letter_model(rng, dev, WP_N)
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer)
    batch = wordpiece_batch(rng, dev)
    li = model.output_length(batch["feature_lengths"]).to(torch.int32)
    targets, lo = batch["targets"], batch["target_lengths"]

    # the first step's gradients, K9 against the two scans (fp32)
    with torch.no_grad():
        em0 = model(batch["features"])
    check(tuple(em0.shape) == (WP_T, WP_B, WP_N), f"emissions shape {tuple(em0.shape)}")
    grads = {}
    for dual in (None, False):
        tr = state.transition.detach().clone().requires_grad_(True)
        em = em0.clone().requires_grad_(True)
        with force_dual_streams(dual):
            loss = asg_loss(tr, em, targets, li, lo)
        grads[dual] = torch.autograd.grad(loss, (tr, em))
    grad_errs = {}
    for label, g, w in zip(("transition", "emissions"), grads[None], grads[False]):
        check(bool(torch.isfinite(g).all()), f"non-finite {label} gradient")
        assert_near(f"wordpiece grad {label} vs the scans", g, w, 1e-3, 1e-4)
        grad_errs[label] = max_err(g, w)
    del grads

    def finite_grads():
        return all(bool(torch.isfinite(p.grad).all())
                   for p in (*model.parameters(), state.transition))

    state, loss_before = step(state, batch)  # warm-up; its loss precedes any update
    loss_before = float(loss_before)
    counters = (fcc_dual_streams, asg_scores_fused, _fwd_store_kernel, _bwd_kernel)
    for c in counters:
        c.launches = 0
    losses, latencies = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        check(finite_grads(), "non-finite gradient in a wordpiece training step")
    launches = {c.__name__: c.launches for c in counters}
    check(launches == {"fcc_dual_streams": 5, "asg_scores_fused": 0,
                       "_fwd_store_kernel": 0, "_bwd_kernel": 0},
          f"each wordpiece step must launch K9 once and K1, K1s, K2 never: {launches}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    with torch.no_grad():
        loss_after = float(loss_fn(model, state, batch))
    check(loss_after < loss_before, f"loss did not fall: {loss_before} -> {loss_after}")
    median_ms = statistics.median(latencies)
    # a forward-only call runs the beta chain alone: no K9
    before = fcc_dual_streams.launches
    with torch.no_grad():
        full, aligned = asg_scores(state.transition, em0, targets, li, lo)
    torch.cuda.synchronize()
    check(fcc_dual_streams.launches == before, "a forward-only call launched K9")
    check(bool(torch.isfinite(full).all() and (full >= aligned - 1e-2).all()),
          "forward-only wordpiece scores")

    # one more step, synchronised after each stage
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    state.optimizer.zero_grad(set_to_none=True)
    em = model(batch["features"])
    mark()
    loss = asg_loss(state.transition, em, targets, li, lo)
    mark()
    loss.backward()
    mark()
    state.optimizer.step()
    mark()
    stages = dict(zip(("encoder_forward", "asg_loss_forward", "backward", "optimizer_step"),
                      [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]))

    em_fixed = em0.detach().clone().requires_grad_(True)
    tr_fixed = state.transition.detach().clone().requires_grad_(True)

    def criterion():
        out = asg_loss(tr_fixed, em_fixed, targets, li, lo)
        torch.autograd.grad(out, (tr_fixed, em_fixed))

    criterion_ms = time_ms(criterion, runs=10)
    profiled = profile_call("wordpiece_criterion")
    frames = int(li.sum())
    emit({"phase": "train_wordpiece", "card": torch.cuda.get_device_name(0),
          "batch": WP_B, "labels": WP_N, "frames_max": int(li.max()), "frames_sum": frames,
          "steps": 5, "step_ms": latencies, "median_step_ms": median_ms,
          "frames_per_s": frames / (median_ms * 1e-3), "loss_before": loss_before,
          "losses": losses, "loss_after": loss_after, "launches": launches,
          "grad_tolerance": "rtol 1e-3, atol 1e-4 x max|scan gradient| (fp32)",
          "max_abs_err_grads_vs_scans": grad_errs, "stage_ms": stages,
          "criterion_fwd_bwd_ms": criterion_ms,
          "criterion_frames_per_s": frames / (criterion_ms * 1e-3),
          "criterion_profile": profiled})
    return {"fcc_dual_streams": launches["fcc_dual_streams"]}


def align(rng, dev):
    """The full-width letter model answers 3 forced-alignment requests of 64
    utterances after one warm-up request: encoder -> viterbi_align ->
    alignment_segments.  Element 0 of each request has an empty transcript
    (L_out = 0, as ``encode_targets`` gives for one), which must score
    -inf; K12 and K13 must take the route 'auto' takes at S slots."""
    from torch_asg_tpu_torch import alignment_segments, viterbi_align
    from torch_asg_tpu_torch.convert import transition_from_numpy
    from torch_asg_tpu_torch.ops.kernels.common import ROUTES, width_route
    from torch_asg_tpu_torch.ops.kernels.viterbi_kernels import (align_backtrace_pallas,
                                                                 align_forward_pallas)

    model = letter_model(rng, dev).eval()
    trans = transition_from_numpy(rng.normal(size=(N, N)) * 0.5, device=dev,
                                  dtype=torch.float32)
    requests = []
    for _ in range(4):
        feat_lengths = rng.integers(1000, 2001, size=B)
        feats = rng.normal(size=(B, 2000, FEATURES)).astype(np.float32)
        lo = rng.integers(10, S + 1, size=B)
        lo[0] = 0  # an empty transcript
        targets = rng.integers(0, ALPHABET, size=(B, S))
        requests.append([torch.as_tensor(x, device=dev) for x in
                         (feats, feat_lengths, targets.astype(np.int32), lo.astype(np.int32))])
    torch.cuda.synchronize()

    def answer(feats, feat_lengths, targets, lo):
        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)
            ali = viterbi_align(trans, em, targets, li, lo)
            seg = alignment_segments(ali, S)
        torch.cuda.synchronize()
        return em, li, ali, seg

    answer(*requests[0])  # warm-up
    counters = (align_forward_pallas, align_backtrace_pallas)
    for c in counters:
        c.launches = 0
        for route in ROUTES:
            setattr(c, f"launches_{route}", 0)
    latencies, outs = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        outs.append(answer(*req) + (req[2], req[3]))
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    check(launches == {"align_forward_pallas": 3, "align_backtrace_pallas": 3},
          f"each alignment request must launch K12 and K13 once: {launches}")
    align_routes = {f"{c.__name__}.{route}": getattr(c, f"launches_{route}")
                    for c in counters for route in ROUTES}
    want = {k: 3 if k.endswith("." + width_route(S)) else 0 for k in align_routes}
    check(align_routes == want,
          f"every K12 and K13 launch must take the route 'auto' takes: {align_routes}")
    for em, li, ali, seg, targets, lo in outs:
        with torch.no_grad():
            ref = viterbi_align(trans, em, targets, li, lo, impl="xla")
        check(torch.equal(ali.positions, ref.positions), "positions differ from the xla tier")
        check(torch.equal(ali.labels, ref.labels), "labels differ from the xla tier")
        torch.testing.assert_close(ali.scores, ref.scores, rtol=0, atol=0)
        check(bool(ali.scores[0] == -np.inf), "an empty transcript must score -inf")
        check(bool(torch.isfinite(ali.scores[1:]).all()), "non-finite alignment score")
        starts, ends = seg.starts.cpu().numpy(), seg.ends.cpu().numpy()
        li_h, lo_h = li.cpu().numpy(), lo.cpu().numpy()
        for b in range(1, B):
            k = lo_h[b]
            check(starts[b, 0] == 0 and ends[b, k - 1] == li_h[b] - 1
                  and (starts[b, 1:k] == ends[b, :k - 1] + 1).all()
                  and (starts[b, k:] == -1).all(), f"spans of element {b} do not partition it")
    emit({"phase": "align", "card": torch.cuda.get_device_name(0), "requests": 3,
          "batch": B, "frames": T, "latency_ms": latencies,
          "median_latency_ms": statistics.median(latencies), "launches": launches,
          "route_launches": align_routes, "positions_equal_xla": True,
          "empty_transcript_scores": [float(o[2].scores[0]) for o in outs]})
    return launches


def letter_model(rng, dev, num_labels=N):
    """The full-width Wav2Letter (the JAX package's defaults) with a head of
    ``num_labels`` (letters unless told otherwise) and random weights from
    ``rng``."""
    from torch_asg_tpu_torch.convert import wav2letter_from_flax
    from torch_asg_tpu_torch.models import Wav2Letter

    cfg = dict(num_labels=num_labels, channels=256, depth=6, head_channels=512,
               frontend_kernel=11, frontend_stride=2, kernel=7)
    model = Wav2Letter(in_features=FEATURES, device=dev, **cfg)
    model.load_state_dict(wav2letter_from_flax(flax_layout_params(rng, cfg)))
    return model


# train_pallas's first-step gradients against the scan tier's: rtol, and
# atol as a share of the largest scan gradient; in fp32, how many times the
# fp32 scan tier's own count of entries outside that bound around the fp64
# scan tier's the per-lattice tier may reach.
GRAD_TOL = (1e-3, 1e-4)
GRAD_MISS_FACTOR = 2


def train_pallas(rng, dev, utts, labels):
    """The full-width Wav2Letter trains on ``train``'s batch through the
    per-lattice tier, ``make_train_step(model, opt, impl='pallas')``: one
    warm-up step, then 5 timed steps, each ending in a device synchronise.
    Each step must launch K3, K5, K6, K7 and K8 once and K4, K1, K1s, K2 and
    K9 never, K3 and K5-K8 on the route 'auto' takes; a score-only
    ``asg_scores(impl='pallas')`` call must launch K4 and K7 once, on the
    route 'auto' takes, and nothing else.  The first step's gradients are
    held against the scan tier's as the comment below says.  The score-only
    call is timed (``scores_only_ms``, beside the fused tier's
    ``scores_only_fused_ms`` on the same inputs) and profiled
    (``pallas_scores``).  Returns the launch counts of the timed steps (K4:
    of the score-only call)."""
    from torch_asg_tpu_torch import asg_loss, asg_scores
    from torch_asg_tpu_torch.models import create_train_state, loss_fn, make_train_step
    from torch_asg_tpu_torch.ops.kernels.asg_kernels import (_bwd_kernel,
                                                              _fwd_store_kernel,
                                                              asg_scores_fused)
    from torch_asg_tpu_torch.ops.kernels.bigvocab_kernels import fcc_dual_streams

    model = letter_model(rng, dev)
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer, impl="pallas")
    batch = prepare_batch(utts, labels, dev)
    li = model.output_length(batch["feature_lengths"]).to(torch.int32)
    targets, lo = batch["targets"], batch["target_lengths"]

    # the first step's gradients, every kernel on the route 'auto' takes,
    # against the scan tier's within GRAD_TOL: in fp64 every entry; in fp32,
    # the training dtype, against the fp64 scan tier's, entry by entry.
    # There the fp32 scan tier itself misses the bound on a few emission
    # entries (the chains reach thousands of nats, where one fp32 rounding is
    # about 2.4e-4, and a posterior carries a few), and K6's warp route sums
    # its blocks of frames in another order than the scan tier, so its misses
    # fall elsewhere: the per-lattice tier may miss it on at most
    # GRAD_MISS_FACTOR times as many entries of each gradient as the fp32
    # scan tier does (none where the scan tier misses none).
    with torch.no_grad():
        em0 = model(batch["features"])

    def first_grads(impl, dtype):
        tr = state.transition.detach().to(dtype).requires_grad_(True)
        em = em0.detach().to(dtype).requires_grad_(True)
        return torch.autograd.grad(asg_loss(tr, em, targets, li, lo, impl=impl), (tr, em))

    labels = ("transition", "emissions")
    scan32, scan64 = first_grads("scan", torch.float32), first_grads("scan", torch.float64)
    pallas32, pallas64 = first_grads("pallas", torch.float32), first_grads("pallas", torch.float64)
    grad_errs, grad_errs_fp64, fp32_outside = {}, {}, {}
    for label, g, w in zip(labels, pallas64, scan64):
        assert_near(f"train_pallas grad {label} vs scan, fp64", g, w, *GRAD_TOL)
        grad_errs_fp64[label] = max_err(g, w)
    for label, g, w32, w64 in zip(labels, pallas32, scan32, scan64):
        check(bool(torch.isfinite(g).all()), f"non-finite {label} gradient")
        misses = outside(g.double(), w64, *GRAD_TOL)
        scan_misses = outside(w32.double(), w64, *GRAD_TOL)
        fp32_outside[label] = {"pallas_vs_scan_fp64": misses,
                               "scan_vs_scan_fp64": scan_misses,
                               "pallas_vs_scan": outside(g, w32, *GRAD_TOL),
                               "limit": GRAD_MISS_FACTOR * scan_misses,
                               "elements": g.numel()}
        check(misses <= GRAD_MISS_FACTOR * scan_misses,
              f"train_pallas fp32 grad {label}: {misses} entries outside rtol {GRAD_TOL[0]:g} "
              f"of the fp64 scan tier's, past {GRAD_MISS_FACTOR} x the fp32 scan tier's "
              f"{scan_misses}")
        grad_errs[label] = {"vs_scan": max_err(g, w32), "vs_scan_fp64": max_err(g.double(), w64),
                            "scan_vs_scan_fp64": max_err(w32.double(), w64)}

    def finite_grads():
        return all(bool(torch.isfinite(p.grad).all())
                   for p in (*model.parameters(), state.transition))

    state, _ = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    lattice = lattice_counters()
    counters = (*lattice, asg_scores_fused, _fwd_store_kernel, _bwd_kernel, fcc_dual_streams)
    for c in counters:
        c.launches = 0
    lattice_route_launches(reset=True)
    losses, latencies = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        check(finite_grads(), "non-finite gradient in a per-lattice training step")
    launches = {c.__name__: c.launches for c in counters}
    want = dict.fromkeys(launches, 0)
    want.update({c.__name__: 5 for c in lattice})
    want["fcc_beta_pallas"] = 0
    check(launches == want,
          f"each step must launch K3, K5, K6, K7, K8 once and K4, K1, K1s, K2, K9 never: "
          f"{launches}")
    routes_seen = check_lattice_auto_route(fcc_fwd_pallas=5, fcc_bwd_pallas=5,
                                           fac_alpha_pallas=5, fac_beta_pallas=5,
                                           fac_bwd_pallas=5)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    with torch.no_grad():
        loss_after = float(loss_fn(model, state, batch, impl="pallas"))
    check(loss_after < losses[0], f"loss did not fall: {losses[0]} -> {loss_after}")
    median_ms = statistics.median(latencies)

    # a score-only call: K4 and K7, nothing else, each on the route 'auto' takes
    for c in counters:
        c.launches = 0
    lattice_route_launches(reset=True)

    def scores_only(impl):
        with torch.no_grad():
            return asg_scores(state.transition, em0, targets, li, lo, impl=impl)

    full, aligned = scores_only("pallas")
    ref_full, ref_aligned = scores_only("scan")
    torch.cuda.synchronize()
    score_only = {c.__name__: c.launches for c in counters}
    want = dict.fromkeys(score_only, 0)
    want.update(fcc_beta_pallas=1, fac_beta_pallas=1)
    check(score_only == want, f"a score-only call must launch K4 and K7 only: {score_only}")
    score_only_routes = check_lattice_auto_route(fcc_beta_pallas=1, fac_beta_pallas=1)
    torch.testing.assert_close(full, ref_full, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(aligned, ref_aligned, rtol=1e-4, atol=1e-3)
    # the score-only call timed (and, for orientation, the fused tier's on
    # the same inputs), and profiled in a process of its own
    scores_only_ms = time_ms(lambda: scores_only("pallas"))
    scores_only_fused_ms = time_ms(lambda: scores_only("auto"))
    scores_profile = profile_call("pallas_scores")

    # one more step, synchronised after each stage
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    state.optimizer.zero_grad(set_to_none=True)
    em = model(batch["features"])
    mark()
    loss = asg_loss(state.transition, em, targets, li, lo, impl="pallas")
    mark()
    loss.backward()
    mark()
    state.optimizer.step()
    mark()
    stages = dict(zip(("encoder_forward", "asg_loss_forward", "backward", "optimizer_step"),
                      [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]))

    em_fixed = em0.detach().clone().requires_grad_(True)
    tr_fixed = state.transition.detach().clone().requires_grad_(True)

    def criterion():
        out = asg_loss(tr_fixed, em_fixed, targets, li, lo, impl="pallas")
        torch.autograd.grad(out, (tr_fixed, em_fixed))

    criterion_ms = time_ms(criterion)
    profiled = profile_call("pallas_criterion")
    frames = int(li.sum())
    emit({"phase": "train_pallas", "card": torch.cuda.get_device_name(0), "batch": B,
          "frames_max": int(li.max()), "frames_sum": frames,
          "steps": 5, "step_ms": latencies, "median_step_ms": median_ms,
          "frames_per_s": frames / (median_ms * 1e-3), "losses": losses,
          "loss_after": loss_after, "launches": launches,
          "route_launches": routes_seen, "score_only_launches": score_only,
          "score_only_route_launches": score_only_routes,
          "scores_only_ms": scores_only_ms, "scores_only_fused_ms": scores_only_fused_ms,
          "scores_only_profile": scores_profile,
          "grad_tolerance": (f"rtol {GRAD_TOL[0]:g}, atol {GRAD_TOL[1]:g} x max|scan "
                             f"gradient|: fp64 every entry; fp32 against the fp64 scan tier, "
                             f"at most {GRAD_MISS_FACTOR} x the fp32 scan tier's misses"),
          "max_abs_err_grads_vs_scan": grad_errs,
          "max_abs_err_grads_vs_scan_fp64": grad_errs_fp64,
          "fp32_grads_outside_tolerance": fp32_outside, "stage_ms": stages,
          "criterion_fwd_bwd_ms": criterion_ms,
          "criterion_frames_per_s": frames / (criterion_ms * 1e-3),
          "criterion_profile": profiled})
    counts = {c.__name__: launches[c.__name__] for c in lattice}
    counts["fcc_beta_pallas"] = score_only["fcc_beta_pallas"]
    return counts


# Posteriors of the per-lattice kernels against the scan tier's, fp32: the
# chains reach |alpha + beta| of a few thousand nats at T=1000, where one
# float32 rounding is about 2.4e-4, and each posterior carries a few.
POST_TOL = 2e-3


def serve_posterior(rng, dev):
    """The full-width letter model answers 3 requests of 64 utterances after
    one warm-up request: encoder -> posterior_decode ('auto', hence the
    per-lattice tier: K3 and K5) -> collapse_path.  K3 and K5 must launch
    once a request and K4 never; the posteriors must agree with the scan
    tier's within POST_TOL, and the paths with the scan tier's wherever the
    top two posteriors are more than 2 * POST_TOL apart."""
    from torch_asg_tpu_torch import fcc_posteriors, posterior_decode
    from torch_asg_tpu_torch.convert import transition_from_numpy
    from torch_asg_tpu_torch.ops.posteriors import _pallas_posteriors
    from torch_asg_tpu_torch.runtime import collapse_path

    model = letter_model(rng, dev).eval()
    trans = transition_from_numpy(rng.normal(size=(N, N)) * 0.5, device=dev,
                                  dtype=torch.float32)
    requests = []
    for _ in range(4):
        feat_lengths = rng.integers(1000, 2001, size=B)
        feats = rng.normal(size=(B, 2000, FEATURES)).astype(np.float32)
        requests.append([torch.as_tensor(x, device=dev) for x in (feats, feat_lengths)])
    torch.cuda.synchronize()

    def answer(feats, feat_lengths, sync=lambda: None):
        marks = [time.perf_counter()]

        def mark():
            sync()
            marks.append(time.perf_counter())

        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)
            mark()
            dec = posterior_decode(trans, em, li)
            mark()
            paths = dec.paths.cpu().numpy()
            hyps = [collapse_path(paths[:, b], ALPHABET, MAX_REPS, use_native=True)
                    for b in range(B)]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return (em, li, dec, hyps), [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    answer(*requests[0])  # warm-up
    counters = lattice_counters()
    for c in counters:
        c.launches = 0
    lattice_route_launches(reset=True)
    latencies, outs = [], []
    for req in requests[1:]:
        out, stage_ms = answer(*req)
        latencies.append(sum(stage_ms))
        outs.append(out)
    launches = {c.__name__: c.launches for c in counters}
    want = dict.fromkeys(launches, 0)
    want.update(fcc_fwd_pallas=3, fcc_bwd_pallas=3)
    check(launches == want, f"each request must launch K3 and K5 once, K4 never: {launches}")
    routes_seen = check_lattice_auto_route(fcc_fwd_pallas=3, fcc_bwd_pallas=3)
    _, stage_ms = answer(*requests[1], sync=torch.cuda.synchronize)
    stages = dict(zip(("encoder", "posterior_decode", "paths_to_host_and_collapse"),
                      stage_ms))
    median_ms = statistics.median(latencies)
    # one request under the profiler: the device's busy time and idle share
    request_profile = profile_call("posterior_request")

    for em, li, dec, hyps in outs:
        check(tuple(em.shape) == (T, B, N), f"emissions shape {tuple(em.shape)}")
        check(bool(torch.isfinite(dec.scores).all()), "non-finite decode scores")
        check(bool(((dec.scores > 0) & (dec.scores <= li + 1e-3)).all()),
              "decode scores outside (0, L_in]")
        check(all(len(h) > 0 for h in hyps), "empty hypothesis")
    # the first request against the scan tier on the card
    em, li, dec, _ = outs[0]
    with torch.no_grad():
        post = _pallas_posteriors(trans, em, li)
        ref_post = fcc_posteriors(trans, em, li)
        ref = posterior_decode(trans, em, li, impl="scan")
    post_err = float((post - ref_post).abs().max())
    check(post_err <= POST_TOL, f"posteriors differ from the scan tier's by {post_err}")
    valid = torch.arange(T, device=dev)[:, None] < li[None, :]
    row_sums = post.sum(dim=2)
    check(bool(((row_sums - 1).abs()[valid] < 1e-4).all())
          and bool((row_sums[~valid] == 0).all()), "posterior rows must sum to 1, 0 past L_in")
    top2 = torch.topk(ref_post, 2, dim=2).values
    decided = valid & (top2[..., 0] - top2[..., 1] > 2 * POST_TOL)
    check(torch.equal(dec.paths[decided], ref.paths[decided]),
          "paths differ from the scan tier's where the posteriors decide")
    check(bool((dec.paths[~valid] == -1).all()), "paths must hold -1 past L_in")
    check(bool(((dec.scores - ref.scores).abs() <= POST_TOL * li).all()),
          "decode scores differ from the scan tier's")
    emit({"phase": "serve_posterior", "card": torch.cuda.get_device_name(0),
          "requests": 3, "batch": B, "frames": T, "latency_ms": latencies,
          "median_latency_ms": median_ms, "launches": launches,
          "route_launches": routes_seen, "stage_ms_second_request": stages,
          "request_profile": request_profile, "posterior_tolerance": POST_TOL,
          "max_abs_err_posteriors_vs_scan": post_err,
          "frames_decided": int(decided.sum()), "frames_valid": int(valid.sum()),
          "paths_equal_scan_share": float((dec.paths == ref.paths)[valid].float().mean()),
          "hypothesis_lengths_first_request": [len(h) for h in outs[0][3][:8]]})
    return launches


NBEST_K, BEAM = 4, 16


def rescore(trans, em, li, paths):
    """(scores, bounds): each path of ``paths`` (T, B, R) rescored in
    float64 on the host over the emissions ``em`` (T, B, N) and the
    transition, and the worst-case float32 accumulation error of the
    decoder's sum, 2 L u sum |terms| (two roundings a frame, u = 2^-24)."""
    em = em.double().cpu().numpy()
    tr = trans.double().cpu().numpy()
    p = paths.cpu().numpy().astype(np.int64)
    valid = np.arange(em.shape[0])[:, None, None] < li.cpu().numpy()[None, :, None]
    check(bool(((p >= 0) & (p < em.shape[2]))[np.broadcast_to(valid, p.shape)].all())
          and bool((p[~np.broadcast_to(valid, p.shape)] == -1).all()),
          "paths must hold labels inside L_in and -1 past it")
    q = p.clip(0)
    terms_e = np.where(valid, np.take_along_axis(em, q, axis=2), 0.0)
    terms_t = np.where(valid[1:], tr[q[1:], q[:-1]], 0.0)
    scores = terms_e.sum(axis=0) + terms_t.sum(axis=0)
    mass = np.abs(terms_e).sum(axis=0) + np.abs(terms_t).sum(axis=0)
    return scores, 2.0 * li.cpu().numpy()[:, None] * 2.0 ** -24 * mass


def check_rescore(name, trans, em, li, paths, scores):
    want, tol = rescore(trans, em, li, paths)
    err = np.abs(scores.double().cpu().numpy().reshape(want.shape) - want)
    check(bool((err <= tol).all()), f"{name}: a path rescores {float((err - tol).max())} "
          "past the fp32 accumulation bound")
    return float(err.max())


def serve_nbest(rng, dev):
    """The full-width letter model answers 3 n-best requests of 64
    utterances after a warm-up (encoder -> viterbi_nbest(k=NBEST_K) ->
    native collapse_path of each hypothesis) and 3 beam requests on the same
    features (encoder -> beam_decode(beam_size=BEAM) -> collapse_path);
    beam_nbest(n=NBEST_K, beam_size=BEAM) runs on each request's emissions.
    The card's results must equal the port's CPU run on the same emissions,
    to the bit (additions, maxima and selections only, with one tie rule on
    both devices), here and at the wordpiece shape."""
    from torch_asg_tpu_torch import beam_decode, beam_nbest, viterbi_decode, viterbi_nbest
    from torch_asg_tpu_torch.convert import transition_from_numpy
    from torch_asg_tpu_torch.runtime import collapse_path

    model = letter_model(rng, dev).eval()
    trans = transition_from_numpy(rng.normal(size=(N, N)) * 0.5, device=dev,
                                  dtype=torch.float32)
    requests = []
    for _ in range(4):
        feat_lengths = rng.integers(1000, 2001, size=B)
        feats = rng.normal(size=(B, 2000, FEATURES)).astype(np.float32)
        requests.append([torch.as_tensor(x, device=dev) for x in (feats, feat_lengths)])
    torch.cuda.synchronize()

    def answer(feats, feat_lengths, decoder, sync=lambda: None):
        """One request through ``decoder`` ('nbest' or 'beam')."""
        marks = [time.perf_counter()]

        def mark():
            sync()
            marks.append(time.perf_counter())

        with torch.no_grad():
            em = model(feats)
            li = model.output_length(feat_lengths).to(torch.int32)
            mark()
            if decoder == "nbest":
                res = viterbi_nbest(trans, em, NBEST_K, li)
            else:
                res = beam_decode(trans, em, li, beam_size=BEAM)
            mark()
            paths = res.paths.cpu().numpy().reshape(T, B, -1)
            hyps = [collapse_path(paths[:, b, r], ALPHABET, MAX_REPS, use_native=True)
                    for b in range(B) for r in range(paths.shape[2])]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return (em, li, res, hyps), [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    for decoder in ("nbest", "beam"):
        answer(*requests[0], decoder)  # warm-up
    latencies = {"nbest": [], "beam": [], "beam_nbest": []}
    outs = []
    for req in requests[1:]:
        out, stage_ms = answer(*req, "nbest")
        latencies["nbest"].append(sum(stage_ms))
        beam_out, stage_ms = answer(*req, "beam")
        latencies["beam"].append(sum(stage_ms))
        t0 = time.perf_counter()
        with torch.no_grad():
            bn = beam_nbest(trans, out[0], NBEST_K, out[1], beam_size=BEAM)
        torch.cuda.synchronize()
        latencies["beam_nbest"].append((time.perf_counter() - t0) * 1e3)
        outs.append(out + (beam_out[2], bn))
    names = ("encoder", "decode", "paths_to_host_and_collapse")
    stages = {d: dict(zip(names, answer(*requests[1], d, sync=torch.cuda.synchronize)[1]))
              for d in ("nbest", "beam")}
    profiled = profile_call("serve_nbest")

    errs = {}
    for i, (em, li, nb, hyps, bd, bn) in enumerate(outs):
        check(all(len(h) > 0 for h in hyps), "empty hypothesis")
        with torch.no_grad():
            vd = viterbi_decode(trans, em, li)  # K10 + K11
            full = beam_decode(trans, em, li, beam_size=N)
        check(torch.equal(nb.scores[:, 0], vd.scores) and torch.equal(nb.paths[:, :, 0], vd.paths),
              "rank 0 of viterbi_nbest differs from viterbi_decode")
        check(torch.equal(full.scores, vd.scores),
              "beam_decode at a full beam scores otherwise than viterbi_decode")
        check(torch.equal(bn.scores[:, 0], bd.scores) and torch.equal(bn.paths[:, :, 0], bd.paths),
              "rank 0 of beam_nbest differs from beam_decode")
        for name, res in (("viterbi_nbest", nb), ("beam_nbest", bn)):
            check(bool((res.scores[:, 1:] <= res.scores[:, :-1]).all()),
                  f"{name} scores do not descend along the ranks")
            check(bool(torch.isfinite(res.scores).all()), f"non-finite {name} score")
        for name, res in (("viterbi_nbest", nb), ("beam_decode", bd), ("beam_nbest", bn)):
            err = check_rescore(name, trans, em, li, res.paths.reshape(T, B, -1), res.scores)
            errs[name] = max(errs.get(name, 0.0), err)
        if i == 0:
            # the card against the port's CPU run on the same float32 emissions
            cpu = [x.cpu() for x in (trans, em, li)]
            for name, got, want in (
                    ("viterbi_nbest", nb, viterbi_nbest(cpu[0], cpu[1], NBEST_K, cpu[2])),
                    ("beam_decode", bd, beam_decode(*cpu, beam_size=BEAM)),
                    ("beam_nbest", bn, beam_nbest(cpu[0], cpu[1], NBEST_K, cpu[2],
                                                  beam_size=BEAM))):
                check(torch.equal(got.scores.cpu(), want.scores)
                      and torch.equal(got.paths.cpu(), want.paths),
                      f"{name} on the card differs from its CPU run")

    # the beam decoders at the wordpiece shape, card against CPU
    wp_rng = np.random.default_rng([SEED, 14])
    wp_em = wp_rng.standard_normal((WP_T, WP_B, WP_N), dtype=np.float32)
    wp_trans = wp_rng.standard_normal((WP_N, WP_N), dtype=np.float32) * np.float32(0.5)
    wp_li = wp_rng.integers(WP_T // 2, WP_T + 1, size=WP_B).astype(np.int32)
    wp_li[0] = WP_T
    cpu = [torch.from_numpy(x) for x in (wp_trans, wp_em, wp_li)]
    card = [x.to(dev) for x in cpu]
    wp_ms = {}
    for name, fn in (("beam_decode", lambda a: beam_decode(*a, beam_size=BEAM)),
                     ("beam_nbest", lambda a: beam_nbest(a[0], a[1], NBEST_K, a[2],
                                                         beam_size=BEAM))):
        fn(card)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(card)
        torch.cuda.synchronize()
        wp_ms[name] = (time.perf_counter() - t0) * 1e3
        want = fn(cpu)
        check(torch.equal(got.scores.cpu(), want.scores)
              and torch.equal(got.paths.cpu(), want.paths),
              f"{name} at the wordpiece shape on the card differs from its CPU run")
    emit({"phase": "serve_nbest", "card": torch.cuda.get_device_name(0), "requests": 3,
          "batch": B, "frames": T, "k": NBEST_K, "beam_size": BEAM,
          "latency_ms": latencies,
          "median_latency_ms": {k: statistics.median(v) for k, v in latencies.items()},
          "stage_ms_first_request": stages, "viterbi_nbest_profile": profiled,
          "card_equals_cpu": True, "rank0_equals_viterbi_decode": True,
          "rescore_tolerance": "2 L 2^-24 sum|terms| (fp32 accumulation bound)",
          "max_abs_err_rescored": errs,
          "wordpiece_shape": {"T": WP_T, "B": WP_B, "N": WP_N, "call_ms": wp_ms,
                              "card_equals_cpu": True}})


# Streaming phases: each stream's chunk length is drawn per chunk from
# STREAM_CHUNK frames (cut at the stream's L_in).  fp32 streaming scores are
# held against K1 (and the WFSA scores against the scan tier) at serve's
# fp32 bound STREAM_TOL (rtol, atol); fp64 ones against the fp64 scan tier
# at rtol STREAM_F64_RTOL.
STREAM_CHUNK = (50, 150)
STREAM_TOL = (1e-4, 1e-3)
STREAM_F64_RTOL = 1e-9
LEXICON_WORDS, LEXICON_LETTERS, POSTERIOR_B = 200, (2, 10), 8


def port_kernel_wrappers():
    """The wrappers of the port's 14 kernels, each counting its launches."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak
    from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk
    from torch_asg_tpu_torch.ops.kernels.bigvocab_kernels import fcc_dual_streams

    return (ak.asg_scores_fused, ak._fwd_store_kernel, ak._bwd_kernel, fcc_dual_streams,
            vk.viterbi_forward_pallas, vk.viterbi_backtrace_pallas, vk.align_forward_pallas,
            vk.align_backtrace_pallas) + lattice_counters()


def port_launches(reset=False):
    """{wrapper: launches} over the 14 kernels; with ``reset`` set to 0 first."""
    out = {}
    for w in port_kernel_wrappers():
        if reset:
            w.launches = 0
        out[w.__name__] = w.launches
    return out


def stream_chunks(rng, em, li):
    """The emissions (T, B, N) as a stream of ragged chunks: at each chunk
    stream b draws its length from STREAM_CHUNK, cut at what it has left of
    its L_in, and reads its own next frames.  [(chunk, chunk_lengths)]."""
    t_total, nb, n = em.shape
    li_h = li.cpu().numpy().astype(np.int64)
    consumed = np.zeros(nb, np.int64)
    chunks = []
    while (consumed < li_h).any():
        cl = np.minimum(rng.integers(STREAM_CHUNK[0], STREAM_CHUNK[1] + 1, size=nb),
                        li_h - consumed)
        t_c = int(cl.max())
        idx = np.minimum(consumed[None, :] + np.arange(t_c)[:, None], t_total - 1)
        idx = torch.as_tensor(idx, device=em.device)[:, :, None].expand(t_c, nb, n)
        chunks.append((em.gather(0, idx), torch.as_tensor(cl.astype(np.int32),
                                                          device=em.device)))
        consumed += cl
    return chunks


def cuda_ms(fn):
    """(fn(), its time on the card in ms by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_stream(chunks, trans, pre, lo, dev, dtype, timed=False, mid=None):
    """Feed every chunk to the five streaming surfaces (scores with their
    read-out, Viterbi, alignment, beam, n-best) on ``dev`` at ``dtype``.
    Returns (read-outs at the end, read-outs after chunk ``mid`` or None,
    {surface: [ms per chunk]} when ``timed``)."""
    import torch_asg_tpu_torch as pt

    nb = chunks[0][0].shape[1]
    trans = trans.to(dev, dtype)
    pre = pt.StreamTargets(*(None if x is None else x.to(dev) for x in pre))
    lo = lo.to(dev)
    states = {"scores": pt.streaming_init(nb, N, S, dtype, device=dev),
              "viterbi": pt.streaming_viterbi_init(nb, N, dtype, device=dev),
              "align": pt.streaming_align_init(nb, S, dtype, device=dev),
              "beam": pt.streaming_beam_init(nb, BEAM, dtype, device=dev),
              "nbest": pt.streaming_nbest_init(nb, N, NBEST_K, dtype, device=dev)}
    steps = {
        "scores": lambda st, c, cl: (pt.streaming_update(trans, st, c, chunk_lengths=cl,
                                                         stream_targets=pre), None),
        "viterbi": lambda st, c, cl: pt.streaming_viterbi_update(trans, st, c, cl),
        "align": lambda st, c, cl: pt.streaming_align_update(trans, st, c, chunk_lengths=cl,
                                                             stream_targets=pre),
        "beam": lambda st, c, cl: pt.streaming_beam_update(trans, st, c, cl),
        "nbest": lambda st, c, cl: pt.streaming_nbest_update(trans, st, c, cl),
    }
    outs = {name: [] for name in steps}
    times = {name: [] for name in steps}
    snapshot = None
    for i, (chunk, cl) in enumerate(chunks):
        chunk, cl = chunk.to(dev, dtype), cl.to(dev)
        for name, step in steps.items():
            def call():
                st, out = step(states[name], chunk, cl)
                if name == "scores":
                    pt.streaming_scores(st, lo)  # the per-chunk read-out
                return st, out

            (states[name], out), ms = cuda_ms(call) if timed else (call(), None)
            times[name].append(ms)
            if out is not None:
                outs[name].append(out)
        if i == mid:
            snapshot = stream_readouts(states, outs, pre, lo)
    return stream_readouts(states, outs, pre, lo), snapshot, times


def stream_readouts(states, outs, pre, lo):
    """Every surface's read-out of the frames consumed so far."""
    import torch_asg_tpu_torch as pt

    def cat(name):
        return [torch.cat(x) for x in zip(*outs[name])]

    full, aligned = pt.streaming_scores(states["scores"], lo)
    beam = cat("beam")
    return {
        "full": full, "aligned": aligned,
        "viterbi": pt.streaming_viterbi_backtrace(states["viterbi"], *cat("viterbi")),
        "align": pt.streaming_align_backtrace(states["align"], *cat("align"),
                                              stream_targets=pre),
        "beam": pt.streaming_beam_backtrace(states["beam"], *beam),
        "beam_nbest": pt.streaming_beam_nbest_backtrace(states["beam"], *beam, NBEST_K),
        "nbest": pt.streaming_nbest_backtrace(states["nbest"], *cat("nbest")),
        "valid": cat("viterbi")[1],
    }


def compact(x, valid, t_total):
    """A streamed output (frames, B[, R]) in each element's own frame order:
    the frames it consumed first, -1 after, as (t_total, B[, R])."""
    order = torch.argsort((~valid).to(torch.int8), dim=0, stable=True)
    count = valid.sum(dim=0)
    if x.dim() == 3:
        order, count = order[:, :, None].expand_as(x), count[:, None]
    rows = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (x.dim() - 1)))
    out = torch.where(rows < count, torch.gather(x, 0, order), -1)
    if out.shape[0] < t_total:
        pad = torch.full((t_total - out.shape[0],) + tuple(out.shape[1:]), -1,
                         dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad])
    return out[:t_total]


def check_stream(name, got, trans, em, targets, li, lo, tol):
    """Each read-out of ``got`` against the port's one-shot call on the same
    prefix (lengths ``li``) on the card; paths, positions and labels equal,
    scores within ``tol`` (rtol, atol), the aligned score where L_out >= 1
    (the streaming read-out is -inf at L_out = 0).  {read-out: max |err|}."""
    from torch_asg_tpu_torch import (asg_scores, beam_decode, beam_nbest, viterbi_align,
                                     viterbi_decode, viterbi_nbest)

    valid, t_total = got["valid"], em.shape[0]
    with torch.no_grad():
        ref_full, ref_aligned = asg_scores(trans, em, targets, li, lo)  # K1
        refs = {"viterbi": viterbi_decode(trans, em, li),  # K10 + K11
                "align": viterbi_align(trans, em, targets, li, lo),  # K12 + K13
                "beam": beam_decode(trans, em, li, beam_size=BEAM),
                "beam_nbest": beam_nbest(trans, em, NBEST_K, li, beam_size=BEAM),
                "nbest": viterbi_nbest(trans, em, NBEST_K, li)}
    has = lo >= 1
    check(bool(torch.isneginf(got["aligned"][~has]).all()),
          f"{name}: an empty transcript must score -inf")
    errs = {}
    for key, want, sel in (("full", ref_full, slice(None)), ("aligned", ref_aligned, has)):
        torch.testing.assert_close(got[key][sel], want[sel], rtol=tol[0], atol=tol[1],
                                   msg=lambda m: f"{name} {key}: {m}")
        errs[key] = max_err(got[key][sel], want[sel])
    for key, ref in refs.items():
        res = got[key]
        paths = ("positions", "labels") if key == "align" else ("paths",)
        for field in paths:
            check(torch.equal(compact(getattr(res, field), valid, t_total),
                              getattr(ref, field)),
                  f"{name} {key}.{field} differ from the one-shot call's")
        torch.testing.assert_close(res.scores, ref.scores, rtol=tol[0], atol=tol[1],
                                   msg=lambda m: f"{name} {key} scores: {m}")
        errs[key] = max_err(res.scores, ref.scores)
    return errs


def serve_stream(rng, dev):
    """The full-width letter model encodes 64 utterances once; the emissions
    reach the streaming API as ragged chunks (``stream_chunks``), and after
    every chunk the stream updates its scores (and reads them) and its
    Viterbi, alignment, beam (BEAM) and n-best (NBEST_K) states.  Read-outs
    after the middle chunk and at the end are held against the port's one-shot
    calls on the same prefixes on the card (asg_scores through K1,
    viterbi_decode through K10 + K11, viterbi_align through K12 + K13,
    beam_decode, beam_nbest, viterbi_nbest); a float64 stream against the
    float64 scan tier at STREAM_F64_RTOL; the float64 stream on the card
    equal to the same stream on the CPU.  The streaming updates launch no
    kernel of the port.  Timed: each surface's update per chunk (CUDA
    events), the whole-stream request (first chunk to hypotheses on the
    host), and one chunk profiled in a new process (``stream_chunk``)."""
    import torch_asg_tpu_torch as pt
    from torch_asg_tpu_torch.convert import transition_from_numpy
    from torch_asg_tpu_torch.runtime import collapse_path

    model = letter_model(rng, dev).eval()
    trans = transition_from_numpy(rng.normal(size=(N, N)) * 0.5, device=dev,
                                  dtype=torch.float32)
    feat_lengths = torch.as_tensor(rng.integers(1000, 2001, size=B), device=dev)
    feats = torch.as_tensor(rng.normal(size=(B, 2000, FEATURES)).astype(np.float32),
                            device=dev)
    lo_h = rng.integers(10, S + 1, size=B)
    lo_h[0] = 0  # an empty transcript
    lo = torch.as_tensor(lo_h.astype(np.int32), device=dev)
    targets = torch.as_tensor(rng.integers(0, ALPHABET, size=(B, S)).astype(np.int32),
                              device=dev)
    with torch.no_grad():
        em = model(feats)
        li = model.output_length(feat_lengths).to(torch.int32)
    chunks = stream_chunks(rng, em, li)
    mid = len(chunks) // 2
    pre = pt.streaming_targets(trans, targets, N, lo)

    with torch.no_grad():
        run_stream(chunks, trans, pre, lo, dev, torch.float32)  # warm-up
        port_launches(reset=True)
        end, at_mid, times = run_stream(chunks, trans, pre, lo, dev, torch.float32,
                                        timed=True, mid=mid)
        stream_launches = port_launches()
        check(not any(stream_launches.values()),
              f"the streaming updates launched kernels of the port: {stream_launches}")
        li_mid = sum(cl for _, cl in chunks[:mid + 1]).to(torch.int32)
        errs = {"end": check_stream("fp32 end", end, trans, em, targets, li, lo, STREAM_TOL),
                "mid": check_stream("fp32 mid", at_mid, trans, em, targets, li_mid, lo,
                                    STREAM_TOL)}

        # float64: the card against the fp64 scan tier, and against the CPU
        em64, tr64 = em.double(), trans.double()
        pre64 = pt.streaming_targets(tr64, targets, N, lo)
        end64 = run_stream(chunks, tr64, pre64, lo, dev, torch.float64)[0]
        ref_full, ref_aligned = pt.asg_scores(tr64, em64, targets, li, lo, impl="scan")
        has = lo >= 1
        torch.testing.assert_close(end64["full"], ref_full, rtol=STREAM_F64_RTOL, atol=0)
        torch.testing.assert_close(end64["aligned"][has], ref_aligned[has],
                                   rtol=STREAM_F64_RTOL, atol=0)
        errs["fp64_vs_scan"] = {"full": max_err(end64["full"], ref_full),
                                "aligned": max_err(end64["aligned"][has], ref_aligned[has])}
        cpu = torch.device("cpu")
        end_cpu = run_stream([(c.cpu(), cl.cpu()) for c, cl in chunks], tr64.cpu(),
                             pre64, lo.cpu(), cpu, torch.float64)[0]
        for key in ("viterbi", "align", "beam", "beam_nbest", "nbest"):
            for field, got in end64[key]._asdict().items():
                check(torch.equal(got.cpu(), getattr(end_cpu[key], field)),
                      f"fp64 stream {key}.{field} on the card differs from the CPU's")

    def request():
        """Scores and the best path after every chunk, then the hypotheses."""
        with torch.no_grad():
            st = pt.streaming_init(B, N, S, device=dev)
            vst = pt.streaming_viterbi_init(B, N, device=dev)
            bps, vals = [], []
            for chunk, cl in chunks:
                st = pt.streaming_update(trans, st, chunk, chunk_lengths=cl,
                                         stream_targets=pre)
                pt.streaming_scores(st, lo)
                vst, (bp, v) = pt.streaming_viterbi_update(trans, vst, chunk, cl)
                bps.append(bp)
                vals.append(v)
            valid = torch.cat(vals)
            paths = pt.streaming_viterbi_backtrace(vst, torch.cat(bps), valid).paths
            paths, valid = paths.cpu().numpy(), valid.cpu().numpy()
        return [collapse_path(paths[valid[:, b], b], ALPHABET, MAX_REPS, use_native=True)
                for b in range(B)]

    request()  # warm-up
    latencies = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps = request()
        latencies.append((time.perf_counter() - t0) * 1e3)
    check(all(len(h) > 0 for h in hyps), "empty hypothesis")
    profiled = profile_call("stream_chunk")
    lengths = [int(cl.max()) for _, cl in chunks]
    emit({"phase": "serve_stream", "card": torch.cuda.get_device_name(0), "batch": B,
          "frames": T, "labels": N, "slots": S, "chunks": len(chunks),
          "chunk_frames": STREAM_CHUNK, "chunk_tensor_frames": lengths,
          "beam_size": BEAM, "k": NBEST_K, "mid_chunk": mid,
          "update_ms_median": {k: statistics.median(v) for k, v in times.items()},
          "update_us_per_frame_median": {
              k: statistics.median(1e3 * ms / t for ms, t in zip(v, lengths))
              for k, v in times.items()},
          "request_ms": latencies, "median_request_ms": statistics.median(latencies),
          "stream_chunk_profile": profiled, "stream_kernel_launches": stream_launches,
          "tolerance_fp32": f"rtol {STREAM_TOL[0]}, atol {STREAM_TOL[1]} (serve's)",
          "tolerance_fp64": f"rtol {STREAM_F64_RTOL}", "max_abs_err": errs,
          "paths_equal_one_shot": True, "fp64_card_equals_cpu": True})


def lexicon_words(rng):
    """LEXICON_WORDS words of LEXICON_LETTERS letters each, drawn from ``rng``."""
    return [rng.integers(0, ALPHABET, size=int(n)).astype(np.int32)
            for n in rng.integers(LEXICON_LETTERS[0], LEXICON_LETTERS[1] + 1,
                                  size=LEXICON_WORDS)]


def wfsa(rng, dev):
    """Generic acceptor scoring on the card at B=64, T=1000, N=30 (seeded
    emissions, ragged lengths): the full automaton against fcc_score and
    (its best path) viterbi_decode (K10 + K11), the chain against fac_score
    for four utterances, fp32 within STREAM_TOL and fp64 within
    STREAM_F64_RTOL; a looped lexicon of LEXICON_WORDS words scored and
    decoded, its streaming surfaces over ragged chunks equal to the one-shot
    calls, posteriors at B=POSTERIOR_B (``torch.cuda.max_memory_allocated``
    over the call, and its rise above the call's start); wfsa_score,
    wfsa_posteriors and wfsa_viterbi twice each with the same bits.  The
    acceptor calls launch no kernel of the port."""
    import torch_asg_tpu_torch as pt
    from torch_asg_tpu_torch.ops.fac import make_aligned
    from torch_asg_tpu_torch.ops.wfsa import _plan

    em = torch.as_tensor(rng.normal(size=(T, B, N)).astype(np.float32), device=dev)
    li_h = rng.integers(500, T + 1, size=B).astype(np.int32)
    li_h[0] = T
    li = torch.as_tensor(li_h, device=dev)
    trans = torch.as_tensor((rng.normal(size=(N, N)) * 0.5).astype(np.float32), device=dev)
    targets = torch.as_tensor(rng.integers(0, ALPHABET, size=(B, S)).astype(np.int32),
                              device=dev)
    lo = torch.as_tensor(rng.integers(10, S + 1, size=B).astype(np.int32), device=dev)
    errs, ms = {}, {}
    with torch.no_grad():
        for dtype, (rtol, atol) in ((torch.float32, STREAM_TOL),
                                    (torch.float64, (STREAM_F64_RTOL, 0.0))):
            x, tr = em.to(dtype), trans.to(dtype)
            tag = str(dtype).split(".")[1]
            full = pt.full_wfsa(tr)
            got, ms[f"full_score_{tag}"] = cuda_ms(lambda: pt.wfsa_score(full, x, li))
            want = pt.fcc_score(tr, x, li)
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            errs[f"full_vs_fcc_{tag}"] = max_err(got, want)
            lat = make_aligned(tr, x, targets, li, lo)
            want = pt.fac_score(tr, x, targets, li, lo)
            got = torch.stack([pt.wfsa_score(
                pt.chain_wfsa(targets[b, :lo[b]], lat.self_trans[b, :lo[b]],
                              lat.next_trans[b, :lo[b]]), x[:, b:b + 1], li[b:b + 1])[0]
                for b in range(4)])
            torch.testing.assert_close(got, want[:4], rtol=rtol, atol=atol)
            errs[f"chain_vs_fac_{tag}"] = max_err(got, want[:4])
        port_launches(reset=True)
        vit = pt.wfsa_viterbi(pt.full_wfsa(trans), em, li)
        acceptor_launches = port_launches()
        ref = pt.viterbi_decode(trans, em, li)  # K10 + K11
        check(torch.equal(vit.labels, ref.paths) and torch.equal(vit.states, ref.paths),
              "the full automaton's best path differs from viterbi_decode's")
        torch.testing.assert_close(vit.scores, ref.scores, rtol=STREAM_TOL[0],
                                   atol=STREAM_TOL[1])
        errs["full_viterbi_vs_viterbi_decode"] = max_err(vit.scores, ref.scores)

        # the looped lexicon
        port_launches(reset=True)
        lex = pt.lexicon_wfsa(trans, lexicon_words(rng), loop=True)
        plan = _plan(lex.dst, lex.num_states)
        runs = {}
        for name, fn in (("wfsa_score", lambda: pt.wfsa_score(lex, em, li)),
                         ("wfsa_viterbi", lambda: pt.wfsa_viterbi(lex, em, li)),
                         ("wfsa_posteriors",
                          lambda: pt.wfsa_posteriors(lex, em[:, :POSTERIOR_B],
                                                     li[:POSTERIOR_B]))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            first = cuda_ms(fn)[0]
            peak = torch.cuda.max_memory_allocated()
            second, ms[f"lexicon_{name}"] = cuda_ms(fn)
            same = all(torch.equal(a, b) for a, b in
                       zip(*((r,) if isinstance(r, torch.Tensor) else r
                             for r in (first, second))))
            check(same, f"{name} gave other bits on its second run")
            runs[name] = (second, peak, peak - base)
        score, vpath = runs["wfsa_score"][0], runs["wfsa_viterbi"][0]
        check(bool(torch.isfinite(score).all()) and bool((vpath.scores <= score + 1e-3).all()),
              "lexicon scores must be finite and at least the best path's")
        post = runs["wfsa_posteriors"][0]
        sums = post.sum(dim=2)
        inside = torch.arange(T, device=dev)[:, None] < li[None, :POSTERIOR_B]
        check(bool(((sums - 1).abs() < 1e-3)[inside].all()) and bool((sums[~inside] == 0).all()),
              "lexicon posteriors must sum to 1 inside each utterance and 0 past it")

        chunks = stream_chunks(rng, em, li)
        st = pt.streaming_wfsa_init(lex, B, device=dev)
        vst = pt.streaming_wfsa_viterbi_init(lex, B, device=dev)
        backs, vals, upd_ms, vupd_ms = [], [], [], []
        for chunk, cl in chunks:
            st, t_ms = cuda_ms(lambda: pt.streaming_wfsa_update(lex, st, chunk, cl))
            (vst, (bk, v)), v_ms = cuda_ms(
                lambda: pt.streaming_wfsa_viterbi_update(lex, vst, chunk, cl))
            backs.append(bk)
            vals.append(v)
            upd_ms.append(t_ms)
            vupd_ms.append(v_ms)
        valid = torch.cat(vals)
        got = pt.streaming_wfsa_scores(lex, st)
        torch.testing.assert_close(got, score, rtol=STREAM_TOL[0], atol=STREAM_TOL[1])
        errs["lexicon_stream_vs_one_shot"] = max_err(got, score)
        vgot = pt.streaming_wfsa_viterbi_backtrace(lex, vst, torch.cat(backs), valid)
        for field in ("states", "labels"):
            check(torch.equal(compact(getattr(vgot, field), valid, T), getattr(vpath, field)),
                  f"the streamed lexicon {field} differ from wfsa_viterbi's")
        check(torch.equal(vgot.scores, vpath.scores), "streamed lexicon best-path scores")
        lex_launches = port_launches()
    for counts in (acceptor_launches, lex_launches):
        check(not any(counts.values()), f"the acceptor calls launched port kernels: {counts}")
    lengths = [int(cl.max()) for _, cl in chunks]
    emit({"phase": "wfsa", "card": torch.cuda.get_device_name(0), "batch": B, "frames": T,
          "labels": N, "lexicon": {"words": LEXICON_WORDS, "states": lex.num_states,
                                   "arcs": lex.num_arcs,
                                   "in_degree_buckets": [list(s) for s in plan.shapes]},
          "call_ms": ms, "chunks": len(chunks),
          "stream_update_ms_median": {"streaming_wfsa_update": statistics.median(upd_ms),
                                      "streaming_wfsa_viterbi_update":
                                          statistics.median(vupd_ms)},
          "stream_update_us_per_frame_median": {
              "streaming_wfsa_update": statistics.median(
                  1e3 * m / t for m, t in zip(upd_ms, lengths)),
              "streaming_wfsa_viterbi_update": statistics.median(
                  1e3 * m / t for m, t in zip(vupd_ms, lengths))},
          "max_memory_allocated_bytes": {k: v[1] for k, v in runs.items()},
          "peak_above_call_start_bytes": {k: v[2] for k, v in runs.items()},
          "posterior_batch": POSTERIOR_B, "bit_identical_twice": True,
          "tolerance_fp32": f"rtol {STREAM_TOL[0]}, atol {STREAM_TOL[1]}",
          "tolerance_fp64": f"rtol {STREAM_F64_RTOL}", "max_abs_err": errs,
          "viterbi_paths_equal_viterbi_decode": True, "stream_equals_one_shot": True})


# --- phase 14: parallel/ on every card, checkpoints, examples, profiling ------

PARALLEL_TIMEOUT_S = 600
DP_LOSS_RTOL = 1e-5  # the dp step's fp32 loss against the single-process step's
FP64_RTOL = 1e-9  # vp and seq in float64 against the scan tier
SEQ_CHUNKS = 4


def parallel_rank(rank, world, device_type="cuda"):
    """One rank of the ``parallel`` phase (one per card, NCCL): the letter
    model's data-parallel train step and the three dp decoders against the
    single-process calls, ``asg_loss_vp`` and ``fcc_score_vp`` at the
    wordpiece width, ``asg_loss_seq``, and on rank 0 the chunk transfer
    matrices folded in one process.  Every rank draws the same data from one
    seed and takes its own blocks.  Returns its numbers; any failed check
    raises, which fails the spawn."""
    import copy

    import torch.distributed as dist

    import torch_asg_tpu_torch as pt
    from torch_asg_tpu_torch.models import create_train_state, make_train_step
    from torch_asg_tpu_torch.ops.kernels.asg_kernels import _bwd_kernel, _fwd_store_kernel
    from torch_asg_tpu_torch.ops.kernels.viterbi_kernels import (align_backtrace_pallas,
                                                                 align_forward_pallas,
                                                                 viterbi_backtrace_pallas,
                                                                 viterbi_forward_pallas)
    from torch_asg_tpu_torch.parallel import (asg_loss_dp, asg_loss_seq, asg_loss_vp,
                                              beam_decode_dp, fcc_score_vp, make_mesh,
                                              viterbi_align_dp, viterbi_decode_dp)
    from torch_asg_tpu_torch.parallel.sequence_parallel import (chunk_boundaries,
                                                                loss_from_boundaries)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device(device_type))
    rng = np.random.default_rng([SEED, 18])  # the same data on every rank
    mesh = make_mesh(device=device_type)
    rows = slice(rank * B // world, (rank + 1) * B // world)
    out = {"rank": rank, "world": world, "device": str(dev)}
    counters = (_fwd_store_kernel, _bwd_kernel, viterbi_forward_pallas,
                viterbi_backtrace_pallas, align_forward_pallas, align_backtrace_pallas)
    launches = dict.fromkeys((c.__name__ for c in counters), 0)

    def counted(fn):
        """fn(), with the port's kernel launches inside it added to ``launches``."""
        for c in counters:
            c.launches = 0
        result = fn()
        for c in counters:
            launches[c.__name__] += c.launches
        return result

    # 1. one data-parallel train step against the single-process step
    model = letter_model(rng, dev)
    utts, labels = train_batch(rng)
    batch = prepare_batch(utts, labels, dev)
    block = {k: v[rows] for k, v in batch.items()}
    ref_model = copy.deepcopy(model)
    ref_state = create_train_state(ref_model)
    ref_step = make_train_step(ref_model, ref_state.optimizer)
    state = create_train_state(model)

    def dp_step():
        state.optimizer.zero_grad(set_to_none=True)
        em = model(block["features"])
        li = model.output_length(block["feature_lengths"]).to(torch.int32)
        loss = asg_loss_dp(mesh, state.transition, em, block["targets"], li,
                           block["target_lengths"])
        loss.backward()
        for p in model.parameters():  # the encoder is replicated: all-reduce its grads
            dist.all_reduce(p.grad)
        state.optimizer.step()
        return loss.detach()

    ref_state, ref_loss = ref_step(ref_state, batch)
    dp_loss = counted(dp_step)
    check(abs(float(dp_loss) - float(ref_loss)) <= DP_LOSS_RTOL * abs(float(ref_loss)),
          f"dp loss {float(dp_loss)} against {float(ref_loss)}")
    errs = {"loss": abs(float(dp_loss) - float(ref_loss))}
    named = [*model.named_parameters(), ("transition", state.transition)]
    for (name, p), q in zip(named, [*ref_model.parameters(), ref_state.transition]):
        assert_near(f"dp grad {name}", p.grad, q.grad, *GRAD_TOL)
        errs[name] = max_err(p.grad, q.grad)
    out["dp_max_abs_err"] = errs
    out["dp_step_ms"] = counted(lambda: time_ms(dp_step, runs=5, warmup=1))
    out["single_step_ms"] = time_ms(lambda: ref_step(ref_state, batch), runs=5, warmup=1)

    # 2. the decoders on that batch, bit for bit against the single-process calls
    trans = torch.as_tensor(rng.normal(size=(N, N)) * 0.5, dtype=torch.float32, device=dev)
    with torch.no_grad():
        em = ref_model(batch["features"])
    li = ref_model.output_length(batch["feature_lengths"]).to(torch.int32)
    targets, lo = batch["targets"], batch["target_lengths"].clone()
    lo[0] = 0  # an empty transcript: no alignment, score -inf
    want = (pt.viterbi_decode(trans, em, li), pt.beam_decode(trans, em, li, beam_size=16),
            pt.viterbi_align(trans, em, targets, li, lo))
    got = counted(lambda: (viterbi_decode_dp(mesh, trans, em[:, rows], li[rows]),
                           beam_decode_dp(mesh, trans, em[:, rows], li[rows], beam_size=16),
                           viterbi_align_dp(mesh, trans, em[:, rows], targets[rows],
                                            li[rows], lo[rows])))
    for name, g, w in zip(("viterbi_decode_dp", "beam_decode_dp", "viterbi_align_dp"),
                          got, want):
        for field, a in g._asdict().items():
            b = getattr(w, field)
            check(torch.equal(a, b[rows] if a.dim() == 1 else b[:, rows]),
                  f"{name}.{field} differs from the single-process call")
    check(rank != 0 or got[2].scores[0].item() == float("-inf"),
          "the empty transcript must score -inf")
    out["launches"] = launches

    # 3. vocabulary parallel at the wordpiece width
    vmesh = make_mesh(axis_names=("model",), device=device_type)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = WP_N // world
    lab = slice(rank * n, (rank + 1) * n)
    wp = {"trans": torch.randn((WP_N, WP_N), generator=gen, device=dev) * 0.5,
          "inputs": torch.randn((WP_T, WP_B, WP_N), generator=gen, device=dev),
          "targets": torch.randint(0, WP_N, (WP_B, WP_S), generator=gen, device=dev),
          "li": torch.randint(WP_T // 2, WP_T + 1, (WP_B,), generator=gen, device=dev),
          "lo": torch.randint(WP_S // 2, WP_S + 1, (WP_B,), generator=gen, device=dev)}
    wp["li"][0] = WP_T
    vp = {}
    for dtype, impl, tol in ((torch.float32, "auto", GRAD_TOL),
                             (torch.float64, "scan", (FP64_RTOL, FP64_RTOL))):
        name = str(dtype).split(".")[1]
        tr = wp["trans"].to(dtype, copy=True).requires_grad_(True)
        x = wp["inputs"].to(dtype, copy=True).requires_grad_(True)
        ref = pt.asg_loss(tr, x, wp["targets"], wp["li"], wp["lo"], reduction="none",
                          impl=impl)
        ref.sum().backward()
        with torch.no_grad():
            ref_full = pt.asg_scores(tr, x, wp["targets"], wp["li"], wp["lo"], impl=impl)[0]
        tr_b = tr.detach()[lab].clone().requires_grad_(True)
        x_b = x.detach()[:, :, lab].clone().requires_grad_(True)

        def vp_call():
            tr_b.grad = x_b.grad = None
            loss = asg_loss_vp(vmesh, tr_b, x_b, wp["targets"], wp["li"], wp["lo"],
                               reduction="none")
            loss.sum().backward()
            return loss

        if device_type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        loss, call_ms = cuda_ms(vp_call) if device_type == "cuda" else (vp_call(), None)
        full = fcc_score_vp(vmesh, tr_b.detach(), x_b.detach(), wp["li"])
        errs = {}
        for label, g, w in (("loss", loss.detach(), ref.detach()), ("fcc_score", full, ref_full),
                            ("transition_rows", tr_b.grad, tr.grad[lab]),
                            ("emissions", x_b.grad, x.grad[:, :, lab])):
            assert_near(f"vp {name} {label}", g, w, *tol)
            errs[label] = max_err(g, w)
        vp[name] = {"against": impl, "tolerance": tol, "max_abs_err": errs,
                    "call_ms": call_ms}
        if device_type == "cuda":
            vp[name]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
            vp[name]["above_start_bytes"] = torch.cuda.max_memory_allocated() - base
        del tr, x, ref, tr_b, x_b, loss
    out["vp"] = vp
    del wp

    # 4. sequence parallel, fp64, against the scan tier
    smesh = make_mesh(axis_names=("seq",), device=device_type)
    trans64, em64, tgt64, li64, lo64 = lattice_case(rng, dev, torch.float64, B, T, N, S,
                                                    (T // 2, T), (10, S))
    tr = trans64.clone().requires_grad_(True)
    x = em64.clone().requires_grad_(True)
    ref = pt.asg_loss(tr, x, tgt64, li64, lo64, reduction="sum", impl="scan")
    ref.backward()
    c_len = T // world
    frames = slice(rank * c_len, (rank + 1) * c_len)
    tr_s = trans64.clone().requires_grad_(True)
    x_s = em64[frames].clone().requires_grad_(True)

    def seq_call():
        loss = asg_loss_seq(smesh, tr_s, x_s, tgt64, li64, lo64, reduction="sum")
        loss.backward()
        return loss

    loss, seq_ms = cuda_ms(seq_call) if device_type == "cuda" else (seq_call(), None)
    errs = {}
    for label, g, w in (("loss", loss.detach(), ref.detach()), ("transition", tr_s.grad, tr.grad),
                        ("emissions", x_s.grad, x.grad[frames])):
        assert_near(f"seq {label}", g, w, FP64_RTOL, FP64_RTOL)
        errs[label] = max_err(g, w)
    out["seq"] = {"max_abs_err": errs, "call_ms": seq_ms, "frames_per_rank": c_len}

    # 5. the transfer-matrix math in one process: SEQ_CHUNKS chunks folded,
    # the all-gather replaced by stacking
    if rank == 0:
        tr_c = trans64.clone().requires_grad_(True)
        x_c = em64.clone().requires_grad_(True)
        per = T // SEQ_CHUNKS
        bounds = [chunk_boundaries(tr_c, x_c[p * per:(p + 1) * per], tgt64, li64, lo64,
                                   p * per, p == 0) for p in range(SEQ_CHUNKS)]
        loss = loss_from_boundaries([b[0] for b in bounds], [b[1] for b in bounds],
                                    lo64).sum()
        loss.backward()
        errs = {}
        for label, g, w in (("loss", loss.detach(), ref.detach()),
                            ("transition", tr_c.grad, tr.grad), ("emissions", x_c.grad, x.grad)):
            assert_near(f"transfer-matrix fold {label}", g, w, FP64_RTOL, FP64_RTOL)
            errs[label] = max_err(g, w)
        out["chunk_fold"] = {"chunks": SEQ_CHUNKS, "max_abs_err": errs}
    return out


def checkpoint_resume(rng, dev):
    """The full-width letter train state saved after step 2 and restored into
    a fresh state (other weights, no optimizer state): step 3 must equal the
    uninterrupted run's bit for bit.  cuDNN runs deterministic algorithms
    here (some of its weight-gradient algorithms add with atomics)."""
    import tempfile

    from torch_asg_tpu_torch.models import create_train_state, make_train_step

    cfg_rng = np.random.default_rng([SEED, 19])
    batch = prepare_batch(*train_batch(cfg_rng), dev)
    weights = letter_model(cfg_rng, dev).state_dict()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for stop in (3, 2):
            model = letter_model(np.random.default_rng(0), dev)
            model.load_state_dict(weights)
            state = create_train_state(model)
            step = make_train_step(model, state.optimizer)
            for _ in range(stop):
                state, loss = step(state, batch)
            runs.append((state, step, loss))
        (straight, _, loss_straight), (part, _, _) = runs
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "ckpt.pt"
            torch.save({"model": part.model.state_dict(), "transition": part.transition.detach(),
                        "optimizer": part.optimizer.state_dict(), "step": part.step}, path)
            model = letter_model(np.random.default_rng(1), dev)  # other weights
            fresh = create_train_state(model)
            ckpt = torch.load(path, map_location=dev, weights_only=True)
            size = path.stat().st_size
        model.load_state_dict(ckpt["model"])
        with torch.no_grad():
            fresh.transition.copy_(ckpt["transition"])
        fresh.optimizer.load_state_dict(ckpt["optimizer"])
        fresh.step = ckpt["step"]
        fresh, loss_resumed = make_train_step(model, fresh.optimizer)(fresh, batch)
    finally:
        torch.backends.cudnn.deterministic = prev
    check(fresh.step == straight.step == 3, "step counters")
    check(torch.equal(loss_resumed, loss_straight),
          f"resumed loss {float(loss_resumed)} against {float(loss_straight)}")
    same = all(torch.equal(a, b) for a, b in zip(
        [*straight.model.parameters(), straight.transition],
        [*fresh.model.parameters(), fresh.transition]))
    check(same, "the resumed step's parameters differ from the uninterrupted run's")
    return {"bit_identical": True, "loss_step3": float(loss_straight),
            "checkpoint_bytes": size}


def run_examples():
    """The three ``examples/*_torch.py`` at their default arguments on the
    card, in this process, their output captured: each must return 0 and
    pass its own assertions.  Returns each one's seconds and last line."""
    import contextlib
    import importlib
    import io

    examples = Path(__file__).resolve().parent / "examples"
    sys.path.insert(0, str(examples))
    try:
        results = {}
        for name in ("train_asg_torch", "stream_decode_torch", "nbest_rescore_torch"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = importlib.import_module(name).main([])
            torch.cuda.synchronize()
            check(rc == 0, f"examples/{name}.py returned {rc}")
            lines = buf.getvalue().strip().splitlines()
            results[name] = {"seconds": time.perf_counter() - t0, "last_line": lines[-1]}
    finally:
        sys.path.remove(str(examples))
    return results


def chained_request(rng, dev):
    """One serving request (encoder -> viterbi_decode -> asg_scores) timed by
    ``utils.profiling.time_fn_chained`` (each request's features depend on the
    previous request's scores; one synchronise and one scalar fetch at the
    end, the fetch's own cost subtracted), beside its CUDA-event median."""
    import torch_asg_tpu_torch as pt
    from torch_asg_tpu_torch.utils.profiling import fetch_overhead_s, time_fn_chained

    model = letter_model(rng, dev).eval()
    trans = torch.as_tensor(rng.normal(size=(N, N)) * 0.5, dtype=torch.float32, device=dev)
    feats = torch.as_tensor(rng.normal(size=(B, 2000, FEATURES)).astype(np.float32),
                            device=dev)
    feat_lengths = torch.as_tensor(rng.integers(1000, 2001, size=B), device=dev)
    targets = torch.as_tensor(rng.integers(0, ALPHABET, size=(B, S)).astype(np.int32),
                              device=dev)
    lo = torch.as_tensor(rng.integers(10, S + 1, size=B).astype(np.int32), device=dev)

    def request(x):
        with torch.no_grad():
            em = model(x)
            li = model.output_length(feat_lengths).to(torch.int32)
            dec = pt.viterbi_decode(trans, em, li)
            full, _ = pt.asg_scores(trans, em, targets, li, lo)
        return full, dec.scores

    fetch_s = fetch_overhead_s(device=dev)
    chained_s = time_fn_chained(request, lambda x0, out: x0 + 0.0 * out[0].sum(), feats,
                                iters=10, fetch_s=fetch_s)
    return {"chained_ms": chained_s * 1e3, "cuda_event_median_ms": time_ms(
        lambda: request(feats), runs=10), "fetch_overhead_ms": fetch_s * 1e3}


def parallel(rng, dev):
    """Phase ``parallel``: one rank per card (world = the card count, NCCL,
    rank r on cuda:r) runs ``parallel_rank``; the parent joins every rank
    (``parallel.launch.spawn_ranks``, which fails on any rank's error, exit or
    timeout) and checks that the dp path launched K1 with stores, K2 and
    K10-K13 in every rank; then the checkpoint resume, the three examples and
    the chained serving request, in this process."""
    from torch_asg_tpu_torch.parallel.launch import spawn_ranks

    world = torch.cuda.device_count()
    torch.cuda.empty_cache()  # the ranks share this process's card
    t0 = time.perf_counter()
    ranks = spawn_ranks(parallel_rank, world, device="cuda", timeout_s=PARALLEL_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        check(all(v > 0 for v in r["launches"].values()),
              f"rank {r['rank']}: a kernel of the dp path never launched: {r['launches']}")
    line = {"phase": "parallel", "card": torch.cuda.get_device_name(0), "world": world,
            "backend": "nccl", "spawn_seconds": spawn_s,
            "dp_grad_tolerance": "rtol 1e-3, atol 1e-4 x max|single-process gradient|",
            "dp_loss_rtol": DP_LOSS_RTOL, "fp64_rtol": FP64_RTOL, "ranks": ranks}
    line["checkpoint"] = checkpoint_resume(rng, dev)
    line["examples"] = run_examples()
    line["serving_request"] = chained_request(rng, dev)
    emit(line)


def spill_bytes(log, marker):
    """{kernel: spill store + load bytes} from an ``nvcc -Xptxas -v`` log, for
    every kernel whose mangled name contains ``marker``."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "spill stores" in line:
            if marker in name:
                words = line.replace(",", " ").split()
                # "<n> bytes stack frame, <n> bytes spill stores, <n> bytes spill loads"
                out[name] = sum(int(words[i - 2]) for i, w in enumerate(words)
                                if w == "spill")
            name = None
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    if "--profile" in argv:
        return profile_main(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": False, "tf32_cudnn": False})

    from torch_asg_tpu_torch.ops.kernels import _build
    from torch_asg_tpu_torch.ops.kernels.asg_kernels import asg_scores_fused
    from torch_asg_tpu_torch.ops.kernels.viterbi_kernels import (
        viterbi_backtrace_pallas, viterbi_forward_pallas)

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [line.strip() for p in libs.values()
             for line in p.with_suffix(".log").read_text().splitlines() if "Used" in line]
    warp_spills = spill_bytes(libs["asg_fwd"].with_suffix(".log").read_text(),
                              "asg_fwd_warp_kernelIf")
    bwd_log = libs["asg_bwd"].with_suffix(".log").read_text()
    k2_spills = {**spill_bytes(bwd_log, "asg_bwd_warp_chain_kernelIf"),
                 **spill_bytes(bwd_log, "asg_bwd_warp_post_kernelIf"),
                 **spill_bytes(bwd_log, "asg_bwd_warp_sums_kernelIf")}
    fcc_log = libs["fcc"].with_suffix(".log").read_text()
    k3_k5_spills = {k: v for marker in ("fcc_fwd_warp_kernelIf", "fcc_fwd_log_kernelIf",
                                        "fcc_bwd_post_kernelIf", "fcc_bwd_sums_kernelIf")
                    for k, v in spill_bytes(fcc_log, marker).items()}
    fac_log = libs["fac"].with_suffix(".log").read_text()
    vit_log = libs["viterbi"].with_suffix(".log").read_text()
    k4_k7_spills = {k: v for log, marker in ((fcc_log, "fcc_beta_warp_kernelIf"),
                                             (fcc_log, "fcc_beta_log_kernelIf"),
                                             (fac_log, "fac_beta_warp_kernelIf"))
                    for k, v in spill_bytes(log, marker).items()}
    k8_k10_spills = {k: v for log, marker in ((fac_log, "fac_bwd_post_kernelIf"),
                                              (fac_log, "fac_bwd_sums_kernelIf"),
                                              (vit_log, "viterbi_fwd_warp_kernelIf"),
                                              (vit_log, "viterbi_bp_kernelIf"))
                     for k, v in spill_bytes(log, marker).items()}
    k6_k12_spills = {k: v for log, marker in ((fac_log, "fac_alpha_band_kernelIf"),
                                              (fac_log, "fac_alpha_warp_kernelIf"),
                                              (fac_log, "fac_alpha_fill_kernelIf"),
                                              (vit_log, "align_forward_warp_kernelIf"))
                     for k, v in spill_bytes(log, marker).items()}
    # the backtraces take int rows: their instances are named by RW alone
    k11_k13_spills = {k: v for marker in ("viterbi_backtrace_warp_kernelI",
                                          "align_backtrace_warp_kernelI")
                      for k, v in spill_bytes(vit_log, marker).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "k1_warp_fp32_spill_bytes": warp_spills, "k2_warp_fp32_spill_bytes": k2_spills,
          "k3_k5_warp_fp32_spill_bytes": k3_k5_spills,
          "k4_k7_warp_fp32_spill_bytes": k4_k7_spills,
          "k8_k10_warp_fp32_spill_bytes": k8_k10_spills,
          "k6_k12_warp_fp32_spill_bytes": k6_k12_spills,
          "k11_k13_warp_spill_bytes": k11_k13_spills})
    # K1: two variants x 3 label x 3 slot register counts; K2: the chain and
    # posterior kernels x 3 x 3, and the sums
    check(len(warp_spills) == 18 and not any(warp_spills.values()),
          f"K1's fp32 warp-route instances must not spill: {warp_spills}")
    check(len(k2_spills) == 19 and not any(k2_spills.values()),
          f"K2's fp32 warp-route instances must not spill: {k2_spills}")
    # K3: the chain kernel x 3 label register counts, and the log pass; K5:
    # the posterior kernel x 3, and the sums
    check(len(k3_k5_spills) == 8 and not any(k3_k5_spills.values()),
          f"K3's and K5's fp32 warp-route instances must not spill: {k3_k5_spills}")
    # K4: the chain kernel x 3 label register counts, and the log pass; K7:
    # the chain kernel x 3 slot register counts
    check(len(k4_k7_spills) == 7 and not any(k4_k7_spills.values()),
          f"K4's and K7's fp32 warp-route instances must not spill: {k4_k7_spills}")
    # K8: the posterior kernel x 3 slot register counts, and the sums; K10:
    # the chain and the backpointer pass x 3 label register counts
    check(len(k8_k10_spills) == 10 and not any(k8_k10_spills.values()),
          f"K8's and K10's fp32 warp-route instances must not spill: {k8_k10_spills}")
    # K6: the band, chain and fill kernels x 3 slot register counts; K12: the
    # chain x 3 slot register counts
    check(len(k6_k12_spills) == 12 and not any(k6_k12_spills.values()),
          f"K6's and K12's fp32 warp-route instances must not spill: {k6_k12_spills}")
    # K11 and K13: the walk x 3 row register counts each
    check(len(k11_k13_spills) == 6 and not any(k11_k13_spills.values()),
          f"K11's and K13's warp-route instances must not spill: {k11_k13_spills}")

    rng = np.random.default_rng(SEED)
    k1 = check_k1(rng, dev)
    k10, k11 = check_viterbi(rng, dev)
    k1s, k2 = check_k1s_k2(rng, dev)
    k9 = check_k9(rng, dev)
    k12, k13 = check_align_kernels(rng, dev)
    # the per-lattice phases draw from streams of their own, so the earlier
    # phases see the same data as before they were added
    lattice = check_lattice_kernels(np.random.default_rng([SEED, 4]), dev)
    for k in (k1, k10, k11, k1s, k2, k9, k12, k13, *lattice):
        emit({"phase": "kernel", **k})
    check_grads_vs_scan(rng, dev)

    from torch_asg_tpu_torch.runtime import has_native_runtime, host

    t0 = time.perf_counter()
    check(has_native_runtime(), f"the native host library did not build: {host._lib_error}")
    emit({"phase": "native_runtime", "library": host.library_path().name,
          "seconds": time.perf_counter() - t0})

    counters = (asg_scores_fused, viterbi_forward_pallas, viterbi_backtrace_pallas)
    launches = serve(rng, dev, counters)
    train_launches, (utts, labels) = train(rng, dev)
    launches.update(train_launches)
    launches.update(train_wordpiece(rng, dev))
    launches.update(align(rng, dev))
    rng_pallas = np.random.default_rng([SEED, 41])
    launches.update(train_pallas(rng_pallas, dev, utts, labels))
    serve_posterior(rng_pallas, dev)
    serve_nbest(np.random.default_rng([SEED, 15]), dev)
    serve_stream(np.random.default_rng([SEED, 16]), dev)
    wfsa(np.random.default_rng([SEED, 17]), dev)
    parallel(np.random.default_rng([SEED, 20]), dev)

    src = "torch_asg_tpu_torch/ops/kernels/csrc/"
    meta = (
        (k1, "asg_scores_fused", src + "asg_fwd.cu",
         "torch_asg_tpu/ops/pallas/asg_kernels.py:172"),
        (k10, "viterbi_forward_pallas", src + "viterbi.cu",
         "torch_asg_tpu/ops/pallas/viterbi_kernels.py:61"),
        (k11, "viterbi_backtrace_pallas", src + "viterbi.cu",
         "torch_asg_tpu/ops/pallas/viterbi_kernels.py:366"),
        (k1s, "_fwd_store_kernel", src + "asg_fwd.cu",
         "torch_asg_tpu/ops/pallas/asg_kernels.py:172"),
        (k2, "_bwd_kernel", src + "asg_bwd.cu",
         "torch_asg_tpu/ops/pallas/asg_kernels.py:275"),
        (k9, "fcc_dual_streams", src + "bigvocab.cu",
         "torch_asg_tpu/ops/pallas/bigvocab_kernels.py:78"),
        (k12, "align_forward_pallas", src + "viterbi.cu",
         "torch_asg_tpu/ops/pallas/viterbi_kernels.py:190"),
        (k13, "align_backtrace_pallas", src + "viterbi.cu",
         "torch_asg_tpu/ops/pallas/viterbi_kernels.py:301"),
    )
    meta += tuple((k, k["wrapper"], k["source"], k["replaces"]) for k in lattice)
    kernels = [{
        "name": k["name"], "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[wrapper], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        # the two routes of K1-K8 and K10-K13, timed in this run; the
        # warp-route kernels of K2-K8 and K10-K13, by device time (one
        # profiled call)
        **{key: k[key] for key in ("route_auto", "ms_warp", "ms_block", "us_per_step",
                                   "warp_device_ms") if key in k},
    } for k, wrapper, source, replaces in meta]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel never launched on its path: {[k['name'] for k in kernels]}")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
