"""A plain PyTorch reference of the gated ConvNet of Liptchinsky, Synnaeve
and Collobert (arXiv:1712.09444) trained with ASG, written again from the
paper's equations, for the CPU tests of ``GatedConvNet``.

It imports neither JAX nor the port.  The parameters are a dict under the
port's ``state_dict`` names (``convs.<i>.weight_v``, ``.weight_g``,
``.bias``; ``hidden.*``; ``out.*``) and ``transition``.  For i = 1 .. L:

  z_i = conv1d(pad(h_{i-1}, ((K_i - 1) // 2, K_i // 2)), w_i) + b_i,
  w_i = g_i v_i / ||v_i|| (a norm an output channel over (C_in, K_i)),
  h_i = GLU(z_i) * m_i / (1 - p_i),  GLU(z) = z[:C/2] * sigmoid(z[C/2:]),

then h_{L+1} = GLU(W_h h_L + b_h) * m_{L+1} / (1 - p_{L+1}) and the
emissions W_o h_{L+1} + b_o, with W_h and W_o weight-normalised by rows.
The convolutions run channels first through ``F.conv1d``, the GLU by
slicing and ``torch.sigmoid`` (whose gradient stays finite where
``exp(-x)`` overflows).  The loss is ``oracle.py``'s
ASG (its own forward recursions, autograd for the gradients), the mean
over the batch; AdamW is torch's documented update, written out.

Dropout masks follow one rule, the program's: for each layer in order, a
(B, C, T) tensor of ``mask_dtype`` filled by ``bernoulli_(1 - p)`` from one
``torch.Generator``; C is the layer's output width after the GLU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from oracle import asg_oracle

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def widths(params: dict) -> list:
    """Each dropout's channels: every convolution's output width halved,
    then the hidden layer's."""
    convs = sorted(int(k.split(".")[1]) for k in params if k.endswith(".weight_v")
                   and k.startswith("convs."))
    out = [params[f"convs.{i}.weight_v"].shape[0] // 2 for i in convs]
    return out + [params["hidden.weight_v"].shape[0] // 2]


def masks(generator, params: dict, rates, batch: int, length: int, device,
          mask_dtype=torch.float32) -> list:
    """One boolean keep mask (B, C, T) a layer, drawn in layer order."""
    out = []
    for c, p in zip(widths(params), rates):
        keep = torch.empty((batch, c, length), dtype=mask_dtype, device=device)
        out.append(keep.bernoulli_(1.0 - p, generator=generator) != 0)
    return out


def weight(params: dict, name: str) -> torch.Tensor:
    v, g = params[f"{name}.weight_v"], params[f"{name}.weight_g"]
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim()))).sqrt()
    return v * (g / norm).reshape(-1, *(1,) * (v.dim() - 1))


def glu(z: torch.Tensor, dim: int) -> torch.Tensor:
    a, b = z.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def encoder(params: dict, features: torch.Tensor, rates=None, keep=None) -> torch.Tensor:
    """features (B, T, F) -> emissions (T, B, N); dropout where ``keep``
    (the masks of ``masks``) is given."""
    x = features.transpose(1, 2)  # (B, F, T)
    n_conv = len(widths(params)) - 1
    for i in range(n_conv):
        w = weight(params, f"convs.{i}")
        k = w.shape[-1]
        z = F.conv1d(F.pad(x, ((k - 1) // 2, k // 2)), w, params[f"convs.{i}.bias"])
        x = glu(z, 1)
        if keep is not None:
            x = x * keep[i] / (1.0 - rates[i])
    x = x.transpose(1, 2)  # (B, T, C)
    x = glu(x @ weight(params, "hidden").T + params["hidden.bias"], 2)
    if keep is not None:
        x = x * keep[n_conv].transpose(1, 2) / (1.0 - rates[n_conv])
    em = x @ weight(params, "out").T + params["out.bias"]
    return em.transpose(0, 1)


def loss(params: dict, batch: dict, rates=None, keep=None) -> torch.Tensor:
    """Mean ASG loss of ``batch`` (features, feature_lengths, targets,
    target_lengths); one emission a feature frame."""
    em = encoder(params, batch["features"], rates, keep)
    per = asg_oracle(params["transition"], em, batch["targets"], batch["feature_lengths"],
                     batch["target_lengths"])
    return per.mean()


def loss_and_grads(params: dict, batch: dict, rates=None, keep=None) -> tuple:
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    value = loss(leaves, batch, rates, keep)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, lr, betas, eps, weight_decay, step: int = 1,
               moments=None) -> dict:
    """One AdamW update of ``params`` (new tensors); ``moments`` {name: (m,
    v)} carries the state between steps (zeros at the first)."""
    b1, b2 = betas
    moments = {} if moments is None else moments
    out = {}
    for k, p in params.items():
        g = grads[k]
        m, v = moments.get(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        moments[k] = (m, v)
        m_hat, v_hat = m / (1 - b1 ** step), v / (1 - b2 ** step)
        out[k] = p * (1 - lr * weight_decay) - lr * m_hat / (v_hat.sqrt() + eps)
    return out
