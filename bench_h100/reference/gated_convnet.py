"""The gated ConvNet of Liptchinsky, Synnaeve and Collobert (arXiv:1712.09444)
trained with ASG, in plain PyTorch: a copy of the port's CPU-test reference
(``tests/plain_gated_convnet.py``) that computes in blocks of rows so that a
float64 step at the published widths fits on one card.

For i = 1 .. L:

  z_i = conv1d(pad(h_{i-1}, ((K_i - 1) // 2, K_i // 2)), w_i) + b_i,
  w_i = g_i v_i / ||v_i|| (a norm an output channel over (C_in, K_i)),
  h_i = GLU(z_i) * m_i / (1 - p_i),  GLU(z) = z[:C/2] * sigmoid(z[C/2:]),

then h_{L+1} = GLU(W_h h_L + b_h) * m_{L+1} / (1 - p_{L+1}) and the
emissions W_o h_{L+1} + b_o (rows of W_h and W_o weight-normalised).  The
parameters are a dict under the port's ``GatedConvNet.state_dict()`` names
and ``transition``.  Departures from the CPU reference, none of them in the
mathematics: each convolution is an unfold (a channels-last (rows, C K)
matrix, c * K + k) times the (C_out, C K) weight, ``@`` on cuBLAS, since
cuDNN's float64 convolutions are slow; the ASG loss and AdamW are
``model.py``'s; a step's loss and gradients come in three passes (the
emissions in blocks without autograd, the loss and its gradient in the
emissions on the whole batch, then each block's encoder again with
autograd, fed that gradient), so the 2000-frame ASG recursion runs once
a step and no two blocks' activations are alive at once.  ``round_tf32``
rounds every product's operands to TF32 (the control on the CPU).

Dropout masks follow one rule, the program's: for each layer in order, a
(B, C, T) float32 tensor filled by ``bernoulli_(1 - p)`` from one
``torch.Generator``, C the layer's width after the GLU; a float64 run
draws in float32 and compares, so it takes the stream as the program does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# utterances a block of the encoder's passes: at 2000 frames the widest
# layer's float64 unfold of one block (4 x 2000 rows of 908 x 29) is 1.7 GB
ROWS = 4


def layers(params: dict) -> int:
    """Number of gated convolutions."""
    return sum(1 for k in params if k.startswith("convs.") and k.endswith(".weight_v"))


def widths(params: dict) -> list:
    """Each dropout's channels: every convolution's output width halved,
    then the hidden layer's."""
    out = [params[f"convs.{i}.weight_v"].shape[0] // 2 for i in range(layers(params))]
    return out + [params["hidden.weight_v"].shape[0] // 2]


def masks(generator, params: dict, rates, batch: int, length: int, device) -> list:
    """One boolean keep mask (B, C, T) a layer, drawn in layer order."""
    out = []
    for c, p in zip(widths(params), rates):
        keep = torch.empty((batch, c, length), dtype=torch.float32, device=device)
        out.append(keep.bernoulli_(1.0 - p, generator=generator) != 0)
    return out


def weight(params: dict, name: str) -> torch.Tensor:
    v, g = params[f"{name}.weight_v"], params[f"{name}.weight_g"]
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim()))).sqrt()
    return v * (g / norm).reshape(-1, *(1,) * (v.dim() - 1))


def glu(z: torch.Tensor) -> torch.Tensor:
    a, b = z.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def _mm(a, b, round_tf32):
    return ref.tf32(a) @ ref.tf32(b) if round_tf32 else a @ b


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, round_tf32=False):
    """SAME convolution of channels-last ``x`` (B, T, C) by unfold and ``@``."""
    batch, t, c = x.shape
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
    cols = xp.unfold(1, k, 1).reshape(batch * t, c * k)  # (B T, C K): c * K + k
    z = _mm(cols, w.reshape(w.shape[0], c * k).T, round_tf32) + b
    return z.view(batch, t, -1)


def encoder(params: dict, features: torch.Tensor, rates=None, keep=None,
            round_tf32=False) -> torch.Tensor:
    """features (B, T, F) -> emissions (T, B, N); dropout where ``keep``
    (this batch's rows of ``masks``) is given."""
    x = features
    n = layers(params)
    for i in range(n):
        x = glu(conv_same(x, weight(params, f"convs.{i}"), params[f"convs.{i}.bias"],
                          round_tf32))
        if keep is not None:
            x = x * keep[i].transpose(1, 2) / (1.0 - rates[i])
    x = glu(_mm(x, weight(params, "hidden").T, round_tf32) + params["hidden.bias"])
    if keep is not None:
        x = x * keep[n].transpose(1, 2) / (1.0 - rates[n])
    em = _mm(x, weight(params, "out").T, round_tf32) + params["out.bias"]
    return em.transpose(0, 1)


def loss_and_grads(params: dict, batch: list, rates, keep, round_tf32=False) -> tuple:
    """(mean ASG loss, {leaf: gradient}) of one batch (features,
    feature_lengths, targets, target_lengths), the encoder run ``ROWS``
    rows at a time; ``keep`` the batch's masks (or None)."""
    feats, fl, tg, tl = batch
    total = feats.shape[0]
    blocks = [slice(r, r + ROWS) for r in range(0, total, ROWS)]

    def block_keep(s):
        return None if keep is None else [m[s] for m in keep]

    with torch.no_grad():
        em = torch.cat([encoder(params, feats[s], rates, block_keep(s), round_tf32)
                        for s in blocks], 1)
    em.requires_grad_(True)
    trans = params["transition"].detach().clone().requires_grad_(True)
    with torch.enable_grad():
        loss = ref.asg_loss(trans, em, tg, fl, tl, round_tf32).sum() / total
        d_em, d_trans = torch.autograd.grad(loss, (em, trans))
    del em
    names = [k for k in params if k != "transition"]
    grads = {k: torch.zeros_like(params[k]) for k in names}
    for s in blocks:
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            out = encoder(leaves, feats[s], rates, block_keep(s), round_tf32)
            got = torch.autograd.grad(out, list(leaves.values()), d_em[:, s])
        for k, g in zip(names, got):
            grads[k].add_(g)
    grads["transition"] = d_trans
    return float(loss.detach()), grads
