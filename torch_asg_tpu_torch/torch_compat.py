"""The reference's ``nn.Module`` surface, and its checkpoints.

``ASGLoss`` is the port's module (``asg.py``), whose constructor and
eval-mode contract are the reference's; its single parameter is named
``transition`` as the reference's is, so ``load_state_dict`` of a reference
checkpoint works unchanged.  ``load_reference_transition`` extracts that
matrix as float32 NumPy for code that holds it elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from .asg import ASGLoss

__all__ = ["ASGLoss", "load_reference_transition"]


def load_reference_transition(state_dict_or_path, prefix: str = ""):
    """The learned (N, N) transition matrix of a reference checkpoint, as
    float32 NumPy.

    The reference stores it as the single ``nn.Parameter`` of its module,
    key ``"transition"``, under ``prefix`` (for example ``"criterion."``)
    when the criterion was a submodule.  Accepts a loaded mapping or a path
    for ``torch.load`` (a file that holds a whole module gives its
    ``state_dict``).
    """
    sd = state_dict_or_path
    if not hasattr(sd, "keys"):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):  # a whole module was saved
        sd = sd.state_dict()
    key = prefix + "transition"
    if key not in sd:
        raise KeyError(
            f"{key!r} not in checkpoint (keys: {sorted(sd.keys())[:10]}); "
            f"pass prefix='<module path>.' if the criterion was nested.")
    t = sd[key]
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    t = np.asarray(t, np.float32)
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"transition must be square (N, N); got {t.shape}")
    return t
