"""Online (streaming) recognition example, with the PyTorch port
(``torch_asg_tpu_torch``).

The twin of ``stream_decode.py``: emission chunks arrive a few frames at a
time, per-stream rates differ (as real microphones do), and after every
chunk the recognizer reads out

  * exact prefix scores (full / aligned) via ``streaming_update`` +
    ``streaming_scores``;
  * the current best-path hypothesis via ``streaming_viterbi_update`` +
    ``streaming_viterbi_backtrace``, collapsed to labels by the host
    runtime's ``collapse_path``.

Both read-outs are exact: at the end the streamed hypotheses must equal the
one-shot ``viterbi_decode`` (and, with ``--beam K``, the streamed beam must
equal the one-shot ``beam_decode``) on each stream's delivered frames; the
example asserts it.

Run:  python examples/stream_decode_torch.py [--chunk 10] [--frames 60]
      [--streams 3] [--beam K] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_asg_tpu_torch import (beam_decode, streaming_beam_backtrace, streaming_beam_init,
                                 streaming_beam_update, streaming_init, streaming_scores,
                                 streaming_targets, streaming_update,
                                 streaming_viterbi_backtrace, streaming_viterbi_init,
                                 streaming_viterbi_update, viterbi_decode)
from torch_asg_tpu_torch.runtime import collapse_path

NUM_LABELS = 12


def synthetic_stream(rng, num_streams, total_frames):
    """Emissions that weakly encode a planted label sequence per stream."""
    emissions = rng.normal(0, 0.5, size=(total_frames, num_streams, NUM_LABELS))
    planted = []
    for b in range(num_streams):
        labs, t = [], 0
        while t < total_frames:
            lab = int(rng.integers(0, NUM_LABELS))
            dur = int(rng.integers(3, 8))
            emissions[t : t + dur, b, lab] += 3.0
            labs.append(lab)
            t += dur
        planted.append(labs)
    return emissions.astype(np.float32), planted


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--chunk", type=int, default=10)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--streams", type=int, default=3)
    p.add_argument(
        "--beam", type=int, default=0, metavar="K",
        help="also run the beam-pruned online decoder (streaming_beam_*) "
             "with beam width K; 0 disables",
    )
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    B, T, N = args.streams, args.frames, NUM_LABELS
    emissions, planted = synthetic_stream(rng, B, T)
    transition = torch.zeros((N, N), dtype=torch.float32, device=dev)
    # a short fixed "expected transcript" per stream for the aligned score
    targets = torch.tensor([seq[:4] + [0] * max(0, 4 - len(seq)) for seq in planted],
                           dtype=torch.int32, device=dev)
    target_lengths = torch.full((B,), 4, dtype=torch.int32, device=dev)

    # each stream delivers frames at its own rate (stream b lags b frames
    # per chunk); streaming_targets precomputes the chunk-invariant target
    # gathers once, so every update pays only the per-chunk emission gather
    pre = streaming_targets(transition, targets, N, target_lengths)
    score_st = streaming_init(B, N, int(targets.shape[1]), device=dev)
    vit_st = streaming_viterbi_init(B, N, device=dev)
    if args.beam:
        beam_st = streaming_beam_init(B, args.beam, device=dev)
        beam_hist = ([], [], [])  # labels, backptrs, valid

    bps, vals = [], []
    delivered = np.zeros(B, np.int64)
    for off in range(0, T, args.chunk):
        t_c = min(args.chunk, T - off)
        lengths = np.minimum(np.maximum(t_c - np.arange(B), 0), t_c)
        chunk_lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        # stream b's next frames are its own continuation, not a global slice
        chunk = np.zeros((t_c, B, N), np.float32)
        for b in range(B):
            chunk[:lengths[b], b] = emissions[delivered[b]:delivered[b] + lengths[b], b]
        chunk = torch.as_tensor(chunk, device=dev)

        score_st = streaming_update(transition, score_st, chunk,
                                    chunk_lengths=chunk_lengths, stream_targets=pre)
        vit_st, (bp, v) = streaming_viterbi_update(transition, vit_st, chunk,
                                                   chunk_lengths=chunk_lengths)
        bps.append(bp)
        vals.append(v)
        if args.beam:
            beam_st, outs = streaming_beam_update(transition, beam_st, chunk,
                                                  chunk_lengths=chunk_lengths)
            for hist, x in zip(beam_hist, outs):
                hist.append(x)
        delivered += lengths

        full, aligned = streaming_scores(score_st, target_lengths)
        hyp = streaming_viterbi_backtrace(vit_st, torch.cat(bps), torch.cat(vals))
        paths = hyp.paths.cpu().numpy()
        print(f"after {delivered.tolist()} frames:")
        for b in range(B):
            labels = collapse_path(paths[:, b]).tolist()
            print(f"  stream {b}: full={float(full[b]):8.2f} "
                  f"aligned={float(aligned[b]):8.2f} hyp={labels}")

    # exactness check against the one-shot decoder on each full stream
    emis = torch.as_tensor(emissions, device=dev)
    lengths = torch.as_tensor(delivered, dtype=torch.int32, device=dev)
    one = viterbi_decode(transition, emis, lengths)
    final = streaming_viterbi_backtrace(vit_st, torch.cat(bps), torch.cat(vals))
    # streaming emits each stream's labels at its delivery positions;
    # compare the consumed-frame label sequences
    mine_all, ref_all = final.paths.cpu().numpy(), one.paths.cpu().numpy()
    for b in range(B):
        mine = mine_all[:, b]
        assert mine[mine >= 0].tolist() == ref_all[: delivered[b], b].tolist(), \
            f"stream {b} mismatch"
    print("final streaming hypotheses exactly match the one-shot decoder")

    if args.beam:
        beam_final = streaming_beam_backtrace(beam_st, *(torch.cat(h) for h in beam_hist))
        one_beam = beam_decode(transition, emis, lengths, beam_size=args.beam)
        mine_all, ref_all = beam_final.paths.cpu().numpy(), one_beam.paths.cpu().numpy()
        for b in range(B):
            mine = mine_all[:, b]
            assert mine[mine >= 0].tolist() == ref_all[: delivered[b], b].tolist()
            gap = float(one.scores[b] - beam_final.scores[b])
            print(f"  beam-{args.beam} stream {b}: hyp={collapse_path(mine).tolist()} "
                  f"(score gap to exact: {gap:.4f})")
        print("streaming beam hypotheses match the one-shot beam decoder")
    return 0


if __name__ == "__main__":
    sys.exit(main())
