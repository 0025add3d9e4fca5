"""End-to-end ASG training example on synthetic speech-like data, with the
PyTorch port (``torch_asg_tpu_torch``).

The twin of ``train_asg.py``: the native host runtime packs ragged
utterances and encodes targets into the ASG extended alphabet on a
prefetching worker thread, the Wav2Letter encoder and the ASG criterion
train (on the card, the fused tier's kernels), checkpoints save and resume
through ``torch.save`` / ``torch.load`` (the ``state_dict`` of the model,
the transition and the optimizer, and the step), and the Viterbi decoder
greedy-decodes a trained utterance at the end.

Run:  python examples/train_asg_torch.py [--steps 30] [--checkpoint-dir DIR]
      [--profile-dir DIR] [--impl auto|scan|pallas] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_asg_tpu_torch import viterbi_decode
from torch_asg_tpu_torch.models import Wav2Letter, create_train_state, make_train_step
from torch_asg_tpu_torch.runtime import (BatchPrefetcher, cmvn, collapse_path,
                                         encode_targets, pack_frames)
from torch_asg_tpu_torch.utils.profiling import trace

ALPHABET = 26  # letters; +2 repeat symbols -> 28 labels
MAX_REPS = 2
NUM_LABELS = ALPHABET + MAX_REPS
FEATURE_DIM = 64
KEEP_CHECKPOINTS = 2


def synthetic_raw(rng: np.random.Generator, batch_size: int, max_frames: int):
    """Raw ragged utterances whose features weakly encode a random letter
    sequence (the 'corpus', fixed across epochs like real training)."""
    utts, label_seqs = [], []
    for _ in range(batch_size):
        n_labels = int(rng.integers(3, 8))
        labels = rng.integers(0, ALPHABET, size=n_labels)
        frames_per = rng.integers(2, 5, size=n_labels)
        feats = []
        for lab, k in zip(labels, frames_per):
            f = rng.normal(0, 0.3, size=(int(k), FEATURE_DIM)).astype(np.float32)
            f[:, lab % FEATURE_DIM] += 2.0  # planted evidence
            feats.append(f)
        utts.append(np.concatenate(feats)[:max_frames])
        label_seqs.append(labels.astype(np.int32))
    return utts, label_seqs


def prepare_batch(utts, label_seqs, device):
    """Host data path for one batch: CMVN + pack + encode (the native
    runtime; runs per step in the prefetcher's worker thread)."""
    features, feat_lengths = pack_frames(cmvn(utts))  # (T, B, F)
    targets, target_lengths = encode_targets(label_seqs, ALPHABET, MAX_REPS)
    batch = {
        "features": np.ascontiguousarray(features.transpose(1, 0, 2)),  # (B, T, F)
        "feature_lengths": feat_lengths,
        "targets": targets,
        "target_lengths": target_lengths,
    }
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def latest_checkpoint(ckpt_dir: Path):
    found = sorted(ckpt_dir.glob("step_*.pt"))
    return found[-1] if found else None


def save_checkpoint(ckpt_dir: Path, state) -> None:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"model": state.model.state_dict(), "transition": state.transition.detach(),
                "optimizer": state.optimizer.state_dict(), "step": state.step},
               ckpt_dir / f"step_{state.step:08d}.pt")
    for old in sorted(ckpt_dir.glob("step_*.pt"))[:-KEEP_CHECKPOINTS]:
        old.unlink()


def restore_checkpoint(path: Path, state, device) -> None:
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    with torch.no_grad():
        state.transition.copy_(ckpt["transition"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = ckpt["step"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--checkpoint-dir", type=str, default="")
    ap.add_argument("--profile-dir", type=str, default="")
    ap.add_argument("--impl", type=str, default="auto")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    torch.manual_seed(0)
    model = Wav2Letter(num_labels=NUM_LABELS, in_features=FEATURE_DIM, channels=128,
                       depth=2, head_channels=128, device=device)
    # optax.adamw(3e-3)'s settings
    state = create_train_state(model, lambda ps: torch.optim.AdamW(
        ps, lr=3e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    train_step = make_train_step(model, state.optimizer, impl=args.impl)

    ckpt_dir = Path(args.checkpoint_dir).resolve() if args.checkpoint_dir else None
    if ckpt_dir is not None:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            restore_checkpoint(latest, state, device)
            print(f"restored checkpoint at step {state.step}")

    rng = np.random.default_rng(0)
    start = state.step
    # a small FIXED corpus, cycled (epochs): the loss descends visibly
    # and the final decode runs on data the model actually trained on
    corpus = [synthetic_raw(rng, args.batch_size, max_frames=32) for _ in range(4)]
    # async input pipeline: each step's CMVN + packing + encoding runs in
    # the worker while the card executes the previous step
    steps_iter = range(start, start + args.steps)
    prefetcher = BatchPrefetcher(
        steps_iter, lambda s: prepare_batch(*corpus[s % len(corpus)], device), depth=2)
    with trace(args.profile_dir or None), prefetcher:
        for step, batch in zip(steps_iter, prefetcher):
            state, loss = train_step(state, batch)
            if step % 5 == 0 or step == start + args.steps - 1:
                print(f"step {step:4d}  loss {float(loss):8.4f}")
            if ckpt_dir is not None and (step + 1) % 10 == 0:
                save_checkpoint(ckpt_dir, state)

    # decode one TRAINED utterance with the trained model
    utts0, label_seqs = corpus[0]
    batch = prepare_batch(utts0, label_seqs, device)
    with torch.no_grad():
        emissions = model(batch["features"])
        lengths = model.output_length(batch["feature_lengths"]).to(torch.int32)
        res = viterbi_decode(state.transition, emissions, lengths)
    hyp = collapse_path(res.paths[:, 0].cpu().numpy(), ALPHABET, MAX_REPS)
    print("ref labels:", label_seqs[0].tolist())
    print("hyp labels:", hyp.tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
