#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card, and check and time
each hand-written kernel against its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises, so the exit code
is nonzero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from ``torch_asg_tpu_torch/ops/kernels/csrc``;
  3. kernels: each kernel against its plain version on the card, at the
     serving shape B=64, T=1000, N=30, S=50 with ragged lengths, plus small
     fp64 and wide-label cases; times are medians of CUDA-event timings;
  4. serve: the full-width Wav2Letter (random weights from a seed) answers 3
     requests of 64 utterances after one warm-up request: encoder ->
     viterbi_decode -> collapse_path -> asg_scores and asg_loss.  Every
     kernel's launch count must rise in those 3 requests; the outputs are
     checked against the log-domain oracle tiers, and one more request,
     synchronised after each stage, shows where its time goes;
  5. the kernel table, the nvidia-smi line, and last the result line.

Precision: float32 matrix products and convolutions run in full float32
(TF32 off for both cuBLAS and cuDNN).  Exits nonzero, printing no result,
when no CUDA device is available.
"""

import json
import statistics
import subprocess
import sys
import time

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


def check_k1(rng, dev):
    """K1 against its plain version: fp32 at the serving shape (timed); fp64
    at a small shape and on degenerate lengths (L_in = 1, L_out = 1,
    L_out > L_in, L_in outside [1, T]); fp32 with E in opted-in shared
    memory (N=200), with E in global memory (N=300), and at the widest
    widths the front-end takes."""
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak

    def run_both(case):
        trans, inputs, targets, li, lo = case
        lat, e, _ = ak._prepare(trans, inputs, targets, li, lo)
        args = (e, lat.self_trans.contiguous(), lat.next_trans.contiguous(),
                inputs.contiguous(), lat.inputs.contiguous(), li, lo)
        got = ak._fwd_scores_kernel(*args)
        want = ak._fwd_scores_plain(*args)
        torch.cuda.synchronize()
        return args, got, want

    results = {}
    f64, f32, tol64, tol32 = torch.float64, torch.float32, (1e-10, 1e-10), (1e-4, 1e-3)
    for name, dtype, shape, li_r, lo_r, tol in (
        ("fp64_small", f64, (4, 40, 12, 9), (9, 40), (1, 9), tol64),
        ("fp64_degenerate", f64, (7, 40, 12, 9), [1, 40, 2, 3, 17, 0, 41],
         [1, 1, 4, 9, 3, 2, 2], tol64),
        ("fp32_n200_smem", f32, (4, 60, 200, 20), (20, 60), (1, 20), tol32),
        ("fp32_n300_global", f32, (4, 60, 300, 20), (20, 60), (1, 20), tol32),
        ("fp32_max_width", f32, (2, 600, 512, 512), (512, 600), (1, 512), tol32),
        ("fp32_serving", f32, (B, T, N, S), (500, 1000), (10, 50), tol32),
    ):
        b, t, n, s = shape
        args, got, want = run_both(lattice_case(rng, dev, dtype, b, t, n, s, li_r, lo_r))
        for g, w in zip(got, want):
            check(not bool(torch.isnan(g).any()), f"K1 {name}: NaN scores")
            torch.testing.assert_close(g, w, rtol=tol[0], atol=tol[1])
        if name == "fp64_degenerate":
            # L_out > L_in: unalignable; L_in outside [1, T]: no path at all
            check(bool((got[1][[2, 3, 5, 6]] == -np.inf).all())
                  and bool((got[0][[5, 6]] == -np.inf).all()),
                  "K1: elements without a path must score -inf")
        else:
            check(bool(torch.isfinite(got[0]).all()), f"K1 {name}: non-finite full scores")
        results[name] = max(float((g - w)[torch.isfinite(w)].abs().max())
                            for g, w in zip(got, want))
    li = args[5]  # the serving case's
    lsum = int(li.sum())
    nbytes = (lsum * (N + S) + N * N + 2 * B * S) * 4 + 2 * B * 4 + 2 * B * 4
    ops = (lsum - B) * (2 * N * N + 4 * N + 8 * S)
    bound_ms, bound_by = bound(nbytes, ops)
    return {
        "name": "asg_fwd_scores (K1, score-only)",
        "max_abs_err": results["fp32_serving"],
        "max_abs_err_by_case": results,
        "tolerance": "fp32 rtol 1e-4 atol 1e-3 (1000 serial steps, other sum order); fp64 1e-10",
        "ms": time_ms(lambda: ak._fwd_scores_kernel(*args)),
        "plain_ms": time_ms(lambda: ak._fwd_scores_plain(*args)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "serial_steps": int(li.max()) - 1,
    }


def check_viterbi(rng, dev):
    """K10 and K11 against their plain versions: bit-identical backpointers,
    end rows and paths, on random and on integer (tie-forcing) emissions, on
    degenerate lengths, with the transition in global memory (N=300), and
    at the kernel's label cap."""
    from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk

    cases = (
        ("fp32_serving", torch.float32, (B, T, N), (500, T), False),
        ("fp32_integer_ties", torch.float32, (B, T, N), (500, T), True),
        ("fp64_small", torch.float64, (4, 40, 12), (20, 40), False),
        ("fp32_degenerate", torch.float32, (4, 50, 30), [1, 2, 50, 49], False),
        ("fp32_n300_global", torch.float32, (4, 60, 300), (30, 60), False),
        ("fp32_label_cap", torch.float32, (2, 20, vk.VITERBI_KERNEL_MAX_LABELS), (10, 20), False),
    )
    serving, errs = None, {}
    for name, dtype, (b, t, n), li_r, integer in cases:
        trans, inputs, _, li, _ = lattice_case(rng, dev, dtype, b, t, n, 1, li_r, [1] * b,
                                               integer)
        d_end, bp = vk.viterbi_forward_pallas(trans, inputs, li)
        d_ref, bp_ref = vk.viterbi_forward_plain(trans, inputs, li)
        _, final = vk.argmax_first(d_ref, dim=1)
        path = vk.viterbi_backtrace_pallas(final, bp_ref, li)
        path_ref = vk.viterbi_backtrace_plain(final, bp_ref, li)
        torch.cuda.synchronize()
        check(torch.equal(bp, bp_ref), f"K10 {name}: backpointers differ")
        check(torch.equal(d_end, d_ref), f"K10 {name}: end rows differ")
        check(torch.equal(path, path_ref), f"K11 {name}: paths differ")
        if name == "fp32_serving":
            serving = (trans, inputs, li, final, bp_ref)
            same = d_end == d_ref  # also where both are -inf
            errs["k10"] = float(torch.where(same, 0.0, (d_end - d_ref).abs()).max())
            errs["k11"] = float((path - path_ref).abs().max())
    trans, inputs, li, final, bp = serving
    lsum = int(li.sum())
    fwd_bytes = (lsum * N + N * N + B + T * B * N + B * N) * 4
    fwd_ops = 2 * T * B * N * N
    bt_bytes = (lsum - B + 2 * B + T * B) * 4
    k10_bound, k10_by = bound(fwd_bytes, fwd_ops)
    k11_bound, k11_by = bound(bt_bytes, 0)
    exact = "bit-identical (max-plus is exact)"
    k10 = {
        "name": "viterbi_forward (K10)", "max_abs_err": errs["k10"], "tolerance": exact,
        "ms": time_ms(lambda: vk.viterbi_forward_pallas(trans, inputs, li)),
        "plain_ms": time_ms(lambda: vk.viterbi_forward_plain(trans, inputs, li)),
        "bound_ms": k10_bound, "bound_by": k10_by, "serial_steps": T - 1,
    }
    k11 = {
        "name": "viterbi_backtrace (K11)", "max_abs_err": errs["k11"], "tolerance": exact,
        "ms": time_ms(lambda: vk.viterbi_backtrace_pallas(final, bp, li)),
        "plain_ms": time_ms(lambda: vk.viterbi_backtrace_plain(final, bp, li)),
        "bound_ms": k11_bound, "bound_by": k11_by, "serial_steps": T - 1,
    }
    return k10, k11


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
    from torch_asg_tpu_torch.convert import transition_from_numpy, wav2letter_from_flax
    from torch_asg_tpu_torch.models import Wav2Letter
    from torch_asg_tpu_torch.runtime import collapse_path

    cfg = dict(num_labels=N, channels=256, depth=6, head_channels=512,
               frontend_kernel=11, frontend_stride=2, kernel=7)
    model = Wav2Letter(in_features=FEATURES, device=dev, **cfg).eval()
    model.load_state_dict(wav2letter_from_flax(flax_layout_params(rng, cfg)))
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

    def answer(feats, feat_lengths, targets, lo, sync=lambda: None):
        """One request; ``sync`` runs after each stage (a no-op when timing
        the whole request)."""
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
            hyps = [collapse_path(paths[:, b], ALPHABET, MAX_REPS) for b in range(B)]
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
    latencies, outs = [], []
    for req in requests:
        out, stage_ms = answer(*req)
        latencies.append(sum(stage_ms))
        outs.append(out)
    launches = {c.__name__: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"serving path never launched {name}")
    # where a request's time goes: the first request again, synchronised
    # after each stage (outside the counted run)
    _, stage_ms = answer(*requests[0], sync=torch.cuda.synchronize)
    stages = dict(zip(("encoder", "viterbi_decode", "paths_to_host_and_collapse",
                       "asg_scores", "asg_loss"), stage_ms))

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
          "launches": launches, "stage_ms_first_request": stages,
          "max_abs_err_scores_vs_scan": max(float((full - ref_full).abs().max()),
                                            float((aligned - ref_aligned).abs().max())),
          "mean_loss": float(loss.mean()),
          "hypothesis_lengths_first_request": [len(h) for h in outs[0][5][:8]]})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    rng = np.random.default_rng(SEED)
    k1 = check_k1(rng, dev)
    k10, k11 = check_viterbi(rng, dev)
    for k in (k1, k10, k11):
        emit({"phase": "kernel", **k})

    counters = (asg_scores_fused, viterbi_forward_pallas, viterbi_backtrace_pallas)
    launches = serve(rng, dev, counters)

    src = "torch_asg_tpu_torch/ops/kernels/csrc/"
    meta = (
        (k1, "asg_scores_fused", src + "asg_fwd.cu",
         "torch_asg_tpu/ops/pallas/asg_kernels.py:172"),
        (k10, "viterbi_forward_pallas", src + "viterbi.cu",
         "torch_asg_tpu/ops/pallas/viterbi_kernels.py:61"),
        (k11, "viterbi_backtrace_pallas", src + "viterbi.cu",
         "torch_asg_tpu/ops/pallas/viterbi_kernels.py:366"),
    )
    kernels = [{
        "name": k["name"], "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[wrapper], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
    } for k, wrapper, source, replaces in meta]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
