"""N-best decoding + external LM rescoring (shallow fusion), with the
PyTorch port (``torch_asg_tpu_torch``).

The twin of ``nbest_rescore.py``: the acoustic model + ASG transitions
propose the k best framewise paths (``viterbi_nbest``), the host collapses
them to label sequences (``collapse_path``), and an external language model
rescores the distinct hypotheses

    rescored = acoustic_score + lm_weight * lm_score(labels)

so a hypothesis that the acoustic pass ranked second can win.

Run:  python examples/nbest_rescore_torch.py [--k 8] [--lm-weight 1.5]
      [--beam K] [--device cuda|cpu]
      (--beam K proposes with ``beam_nbest``: one beam-pruned pass, the
      wordpiece-scale recipe)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_asg_tpu_torch import beam_nbest, viterbi_nbest
from torch_asg_tpu_torch.runtime import collapse_path

NUM_LABELS = 8


def bigram_lm_score(labels, log_bigram):
    """Toy external LM: sum of log bigram probabilities (start-padded)."""
    s = 0.0
    prev = None
    for lab in labels:
        if prev is not None:
            s += float(log_bigram[prev, lab])
        prev = lab
    return s


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--lm-weight", type=float, default=1.5)
    p.add_argument("--beam", type=int, default=0,
                   help="propose via beam_nbest with this beam width "
                        "(0 = exact viterbi_nbest)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(1)
    T, B, N = 40, 2, NUM_LABELS
    emissions = torch.as_tensor(rng.normal(0, 1.0, size=(T, B, N)), dtype=torch.float32,
                                device=dev)
    transition = torch.zeros((N, N), dtype=torch.float32, device=dev)
    # the "external" LM the acoustic pass knows nothing about
    log_bigram = np.log(rng.dirichlet(np.ones(N), size=N))

    if args.beam:
        nb = beam_nbest(transition, emissions, args.k, beam_size=max(args.beam, args.k))
    else:
        nb = viterbi_nbest(transition, emissions, args.k)
    paths, scores = nb.paths.cpu().numpy(), nb.scores.cpu().numpy()
    for b in range(B):
        print(f"utterance {b}:")
        rescored = []
        seen = set()
        for r in range(args.k):
            labels = tuple(collapse_path(paths[:, b, r]).tolist())
            if labels in seen:
                continue  # distinct framewise paths can collapse equal
            seen.add(labels)
            ac = float(scores[b, r])
            lm = bigram_lm_score(labels, log_bigram)
            rescored.append((ac + args.lm_weight * lm, ac, lm, r, labels))
        rescored.sort(key=lambda x: -x[0])
        for tot, ac, lm, r, labels in rescored[:5]:
            marker = " <- new best" if rescored[0][3] != 0 and r == rescored[0][3] else ""
            print(
                f"  ac_rank {r}: total={tot:9.2f} acoustic={ac:8.2f} "
                f"lm={lm:7.2f} labels={list(labels)[:12]}{marker}"
            )
        flipped = rescored[0][3] != 0
        print(f"  LM rescoring {'changed' if flipped else 'kept'} the 1-best")
    return 0


if __name__ == "__main__":
    sys.exit(main())
