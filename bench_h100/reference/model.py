"""Encoder, ASG loss, AdamW and Viterbi scoring in plain PyTorch.

ASG (Collobert et al. 2016): per utterance, loss = full - aligned, where
``full`` is the log-sum over every label path of length L_in of the
emissions plus the transitions ``T[to, from]`` between consecutive frames,
and ``aligned`` the log-sum over the monotonic alignments of the target
labels to the frames (each frame stays on its slot or advances by one).
The fully-connected sum runs as one (B, N) x (N, N) product a frame on
max-shifted exponentials; the aligned one in the log domain with a large
finite number for "impossible", so that no infinity reaches autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30  # "impossible" in the aligned lattice: exp() of it is 0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, 10 explicit mantissa bits, ties to
    even, as a tensor core reads a float32 operand with TF32 on; the
    gradient passes through unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def _round(x, on: bool):
    return tf32(x) if on else x


def encoder(w: dict, features: torch.Tensor, model: dict, round_tf32=False):
    """features (B, T, F) -> emissions (T', B, N): SAME-padded strided
    convolutions with ReLU (the first of stride ``frontend_stride``), then
    the head projection."""
    x = features.transpose(1, 2)
    for i in range(model["depth"] + 2):
        wt, b = w[f"blocks.{i}.conv.weight"], w[f"blocks.{i}.conv.bias"]
        k, s = wt.shape[2], model["frontend_stride"] if i == 0 else 1
        length = x.shape[-1]
        total = max((-(-length // s) - 1) * s + k - length, 0)
        x = F.pad(x, (total // 2, total - total // 2))
        x = F.relu(F.conv1d(_round(x, round_tf32), _round(wt, round_tf32), b, stride=s))
    x = x.transpose(1, 2)
    y = _round(x, round_tf32) @ _round(w["proj.weight"], round_tf32).T + w["proj.bias"]
    return y.transpose(0, 1)


def full_score(trans, em, li, round_tf32=False):
    """(B,) log-sum over all label paths of each utterance's L_in frames."""
    c = trans.detach().max()
    et = _round(torch.exp(trans - c), round_tf32).T
    a = em[0]
    for t in range(1, em.shape[0]):
        m = a.detach().amax(1, keepdim=True)
        nxt = em[t] + c + m + torch.log(_round(torch.exp(a - m), round_tf32) @ et)
        a = torch.where((t < li)[:, None], nxt, a)
    return torch.logsumexp(a, 1)


def aligned_score(trans, em, targets, li, lo):
    """(B,) log-sum over the monotonic alignments of targets[b, :lo[b]] to
    the first li[b] frames."""
    t_total, batch, _ = em.shape
    s_total = targets.shape[1]
    tg = targets.long()
    e_al = em.gather(2, tg[None].expand(t_total, -1, -1))
    stay = trans[tg, tg]
    step = trans[tg[:, 1:], tg[:, :-1]]
    slot = torch.arange(s_total, device=em.device)
    valid = slot[None, :] < lo[:, None]
    neg = torch.full((batch, 1), NEG, dtype=em.dtype, device=em.device)
    a = torch.where((slot == 0)[None, :], e_al[0], NEG)
    for t in range(1, t_total):
        adv = torch.cat([neg, a[:, :-1] + step], 1)
        nxt = torch.where(valid, e_al[t] + torch.logaddexp(a + stay, adv), NEG)
        a = torch.where((t < li)[:, None], nxt, a)
    return a.gather(1, (lo - 1)[:, None].long())[:, 0]


def asg_loss(trans, em, targets, li, lo, round_tf32=False):
    """(B,) ASG loss: full - aligned."""
    return full_score(trans, em, li, round_tf32) - aligned_score(trans, em, targets, li, lo)


def output_length(lengths, stride: int):
    return -(-lengths // stride)


class AdamW:
    """torch's documented AdamW: decoupled decay, then the Adam step with
    bias corrections."""

    def __init__(self, params: dict, lr, betas, eps, weight_decay):
        self.p, self.lr, self.b1, self.b2 = params, lr, betas[0], betas[1]
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def loss_and_grads(params: dict, batches: list, model: dict, round_tf32=False):
    """Mean ASG loss over the rows of every block in ``batches`` (a list of
    (features, feature_lengths, targets, target_lengths) blocks of one
    batch) and its gradient in each leaf, block by block."""
    rows = sum(b[0].shape[0] for b in batches)
    leaves = list(params.values())
    grads = [torch.zeros_like(p) for p in leaves]
    total = 0.0
    for feats, fl, tg, tl in batches:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            em = encoder(params, feats, model, round_tf32)
            li = output_length(fl, model["frontend_stride"])
            loss = asg_loss(params["transition"], em, tg, li, tl, round_tf32).sum() / rows
            got = torch.autograd.grad(loss, leaves)
        for g, d in zip(grads, got):
            g.add_(d)
        total += float(loss.detach())
        for p in leaves:
            p.requires_grad_(False)
    return total, dict(zip(params, grads))


@torch.no_grad()
def viterbi_best(trans, em, li):
    """(B,) best path score over each utterance's L_in frames."""
    d = em[0]
    for t in range(1, em.shape[0]):
        nxt = em[t] + (trans[None] + d[:, None, :]).amax(2)
        d = torch.where((t < li)[:, None], nxt, d)
    return d.amax(1)


@torch.no_grad()
def path_score(trans, em, li, path):
    """(B,) score of the framewise ``path`` (T, B) over each L_in frames."""
    t_total = em.shape[0]
    p = path.long().clamp(min=0)
    valid = torch.arange(t_total, device=em.device)[:, None] < li[None, :]
    emit = em.gather(2, p[:, :, None])[:, :, 0]
    move = trans[p[1:], p[:-1]]
    return (emit * valid).sum(0) + (move * valid[1:]).sum(0)


@torch.no_grad()
def viterbi_decode(trans, em, li):
    """(scores (B,), paths (T, B) int32 with -1 past each length): the best
    path by max-plus recursion and backtrace, ties to the lowest label."""
    t_total = em.shape[0]
    d, back = em[0], []
    for t in range(1, t_total):
        best, arg = (trans[None] + d[:, None, :]).max(2)
        back.append(arg)
        d = torch.where((t < li)[:, None], em[t] + best, d)
    scores, lab = d.max(1)
    rows = torch.arange(em.shape[1], device=em.device)
    paths = torch.full((t_total, em.shape[1]), -1, dtype=torch.int32, device=em.device)
    for t in range(t_total - 1, -1, -1):
        here = t <= li - 1
        paths[t] = torch.where(here, lab, -1).to(torch.int32)
        if t:
            prev = back[t - 1][rows, lab]
            lab = torch.where(t <= li - 1, prev, lab)
    return scores, paths
