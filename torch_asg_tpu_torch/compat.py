"""Drop-in shim with the module signature of zh217/torch-asg.

The reference constructor is ``ASGLoss(num_labels, reduction='mean',
forward_only=False, gpu_no_stream_impl=False)`` and its forward takes
``(inputs, targets, input_lengths=None, target_lengths=None)`` with inputs
(T, B, N) and targets (B, S).  The port's ``ASGLoss`` is already that
``nn.Module``: the transition is an ``nn.Parameter``, eval mode and
``forward_only`` score under ``torch.no_grad()`` (``.backward()`` raises, as
in the reference), and ``gpu_no_stream_impl=True`` runs the log-domain
``impl='scan'`` tier.  So reference users switch by changing one import:

    from torch_asg_tpu_torch.compat import ASGLoss
"""

from .asg import ASGLoss

__all__ = ["ASGLoss"]
