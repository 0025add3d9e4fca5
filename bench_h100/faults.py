"""The control and the planted faults, each a context manager that puts
something in the program's place for the runs inside it.

* ``control``: the plain reference, computed one precision step below the
  configurations' float32 with TF32 off, in the program's place: TF32 on
  for its convolutions and matrix products (on the CPU, which has no TF32,
  every such operand rounded to TF32 instead).  Training: the
  reference's loss and its gradient step the program's own parameters
  through the same AdamW.  Serving: the reference's encoder and Viterbi
  decoder answer the requests.
* ``unchanged_state``: a train step that computes its loss and returns the
  state unchanged.
* ``half_batch``: a train step on the first half of each batch, its mean
  taken over that half.
* ``altered_answer``: ``viterbi_decode`` with one label of one served path
  changed where it is produced.

``readings.py`` reads each at a cell's own size on the card; the tests read
them at a small size on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

from .reference import model as ref


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _sizes(model) -> dict:
    return {"depth": len(model.blocks) - 2, "frontend_stride": model.frontend_stride}


@contextlib.contextmanager
def _tf32(device):
    """TF32 on for the body: the card's own TF32 (the operands' rounding is
    the tensor cores'), or on the CPU the reference's rounding of every
    operand; yields whether the reference must round."""
    if device.type != "cuda":
        yield True
        return
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _train_step(body):
    """A ``make_train_step`` replacement whose step runs ``body``."""
    import torch_asg_tpu_torch.models as models

    return patched(models, "make_train_step",
                   lambda model, optimizer, *a, **k: lambda state, batch:
                   body(model, optimizer, state, batch))


def control_train():
    def body(model, optimizer, state, batch):
        optimizer.zero_grad(set_to_none=True)
        params = dict(model.named_parameters())
        sizes = _sizes(model)
        with _tf32(batch["features"].device) as rnd:
            em = ref.encoder(params, batch["features"], sizes, round_tf32=rnd)
            li = ref.output_length(batch["feature_lengths"], sizes["frontend_stride"])
            loss = ref.asg_loss(state.transition, em, batch["targets"], li,
                                batch["target_lengths"], round_tf32=rnd).mean()
            loss.backward()
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return _train_step(body)


def unchanged_state():
    def body(model, optimizer, state, batch):
        import torch_asg_tpu_torch.models as models

        with torch.no_grad():
            return state, models.loss_fn(model, state, batch)

    return _train_step(body)


def half_batch():
    import torch_asg_tpu_torch.models as models

    make = models.make_train_step

    def body(model, optimizer, state, batch, steps={}):
        step = steps.setdefault(id(model), make(model, optimizer))
        rows = batch["features"].shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})

    return _train_step(body)


class _Decoded:
    def __init__(self, scores, paths):
        self.scores, self.paths = scores, paths


def control_serve():
    from .loops import serve

    def encode(model, features):
        with _tf32(features.device) as rnd:
            return ref.encoder(dict(model.named_parameters()), features, _sizes(model),
                               round_tf32=rnd)

    def decode(transition, emissions, lengths):
        return _Decoded(*ref.viterbi_decode(transition, emissions, lengths))

    stack = contextlib.ExitStack()
    stack.enter_context(patched(serve, "encode", encode))
    stack.enter_context(patched(serve, "decode", decode))
    return stack


def altered_answer():
    import torch_asg_tpu_torch as pt

    real = pt.viterbi_decode

    def decode(transition, emissions, lengths, **kw):
        out = real(transition, emissions, lengths, **kw)
        paths = out.paths.clone()
        paths[1, 0] = (paths[1, 0] + 1) % emissions.shape[2]
        return type(out)(out.scores, paths)

    return patched(pt, "viterbi_decode", decode)


BY_LOOP = {
    "train": {"control": control_train, "unchanged_state": unchanged_state,
              "half_batch": half_batch},
    "serve": {"control": control_serve, "altered_answer": altered_answer},
}
