"""Tropical-semiring kernels: 1-best Viterbi decoding, the max-plus forward
(K10) and the backtrace (K11), and forced alignment, the two-edge forward
with one advance bit per slot (K12) and its backtrace (K13).

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/viterbi.cu``); on CPU tensors it runs the plain version beside it,
a step-by-step loop of the same arithmetic.  Decoding ties resolve to the
lowest source label and alignment ties to staying on the slot, so results
are bit-identical across each kernel, its plain version and the ``'xla'``
tiers of ``ops/viterbi.py``.

K10 has two routes, picked by ``common.width_route`` of the label count:
the warp route (up to 128 labels: one warp per element walks the max-plus
chain alone, then a pass parallel over (element, chunk of frames)
recomputes each step's candidates from the chain's rows and takes the
backpointers) and the block route (one thread per label, up to
``VITERBI_KERNEL_MAX_LABELS``).  K12 has two too, picked by the slot
count: the warp route (up to 128 slots: one warp per element walks the
two-edge chain and stores each advance bit as it goes) and the block route
(one thread per slot, up to ``ALIGN_KERNEL_MAX_WIDTH``); ``align_forward_plain``
is the plain version of both.  K11 and K13 have two routes each, picked by
the label or slot count: the warp route (up to 128: one warp per element
walks the rows from a register ring, one shuffle a frame) and the block
route (a block stages a chunk of rows in shared memory and one thread walks
it); ``viterbi_backtrace_plain`` and ``align_backtrace_plain`` are the plain
versions of both.
"""

from __future__ import annotations

import ctypes

import torch

from .common import (KERNEL_DTYPES, c_function, check_route, check_tensor,
                     count_launch, post_chunk, ptr, raise_on_error, stream_ptr,
                     use_kernel)
from ..fac import AlignedLattice, _shift_right_s
from ..semiring import NEG_INF
from ...utils.lengths import mask_emissions

# The forward kernel's block route runs one thread per destination label in
# one block.
VITERBI_KERNEL_MAX_LABELS = 1024
# The alignment forward runs one thread per target slot in one block; capped
# at the fused criterion's width, as the JAX package caps it.
ALIGN_KERNEL_MAX_WIDTH = 512


def argmax_first(x: torch.Tensor, dim: int):
    """(max, lowest index reaching it) along ``dim``, as int64."""
    best = torch.amax(x, dim=dim, keepdim=True)
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    idx = idx.view(shape).expand_as(x)
    arg = torch.where(x == best, idx, x.shape[dim]).amin(dim=dim)
    return best.squeeze(dim), arg


def viterbi_forward_plain(transition, inputs, input_lengths):
    """Plain version of K10: (d_end (B, N), backptr (T, B, N) int32)."""
    t_total, num_batches, num_labels = inputs.shape
    li = input_lengths.to(inputs.device)
    inputs_m = mask_emissions(inputs, li)
    bp = torch.empty((t_total, num_batches, num_labels), dtype=torch.int32,
                     device=inputs.device)
    bp[0] = torch.arange(num_labels, dtype=torch.int32, device=inputs.device)
    d = inputs_m[0]
    d_end = torch.where((li - 1 == 0)[:, None], d, NEG_INF)
    for t in range(1, t_total):
        best, arg = argmax_first(transition[None, :, :] + d[:, None, :], dim=2)
        d = inputs_m[t] + best
        bp[t] = arg
        d_end = torch.where((li - 1 == t)[:, None], d, d_end)
    return d_end, bp


def _viterbi_forward_split_plain(transition, inputs, input_lengths, chunk=None):
    """Plain version of K10's warp route: ``viterbi_forward_plain``'s
    outputs, the chain and the backpointers taken apart.  Used by the tests;
    the main path runs ``viterbi_forward_plain`` on CPU tensors.

    1. The chain: d_0 = I_0, d_t = I_t + max_j (T[i, j] + d_{t-1}[j]) with
       emissions masked past L_in, so d_t = -inf for t >= L_in; d_end =
       d_{L_in - 1} (-inf when L_in is outside [1, T]).
    2. Per (element, chunk of ``chunk`` frames; default ``post_chunk``):
       backptr[t][i] = the lowest j with T[i, j] + d_{t-1}[j] equal to the
       max over j; the identity at t = 0; 0 where t - 1 >= min(L_in, T),
       which the pass writes without reading d.
    """
    t_total, num_batches, num_labels = inputs.shape
    dev = inputs.device
    if chunk is None:
        chunk = post_chunk(t_total, num_batches)
    li = input_lengths.to(device=dev, dtype=torch.long)
    inputs_m = mask_emissions(inputs, li)

    # ---- 1: the chain
    d = torch.empty_like(inputs_m)
    d[0] = inputs_m[0]
    for t in range(1, t_total):
        d[t] = inputs_m[t] + torch.amax(transition[None, :, :] + d[t - 1][:, None, :], dim=2)
    ends = (li - 1).clamp(0, max(t_total - 1, 0))
    d_end = torch.where(((li >= 1) & (li <= t_total))[:, None],
                        d[ends, torch.arange(num_batches, device=dev)], NEG_INF)

    # ---- 2: the backpointers, a chunk of frames at a time
    bp = torch.empty((t_total, num_batches, num_labels), dtype=torch.int32, device=dev)
    bp[0] = torch.arange(num_labels, dtype=torch.int32, device=dev)
    frames = torch.arange(t_total, device=dev)
    live = li.clamp(0, t_total)
    for t0 in range(0, t_total, chunk):
        lo, hi = max(t0, 1), min(t0 + chunk, t_total)
        if lo >= hi:
            continue
        _, arg = argmax_first(transition[None, None] + d[lo - 1:hi - 1, :, None, :], dim=3)
        dead = frames[lo:hi, None, None] - 1 >= live[None, :, None]
        bp[lo:hi] = torch.where(dead, 0, arg).to(torch.int32)
    return d_end, bp


def viterbi_backtrace_plain(final_labels, backptr, input_lengths):
    """Plain version of K11 (both routes): the (T, B) int32 path, -1 past
    L_in.  Frame L_in - 1 holds ``final_labels`` as given; frame t before it
    holds backptr[t + 1][b, max(path[t + 1], 0)], or 0 where that index is
    N or more (the JAX kernel's one-hot select).

    backptr[t] maps the label at frame t to the label at frame t-1."""
    t_total, num_batches, _ = backptr.shape
    li = input_lengths.to(backptr.device)
    final = final_labels.to(device=backptr.device, dtype=torch.int32)
    pad = torch.full_like(final, -1)
    paths = torch.empty((t_total, num_batches), dtype=torch.int32,
                        device=backptr.device)
    lab = torch.where(li - 1 == t_total - 1, final, pad)
    paths[t_total - 1] = lab
    for t in range(t_total - 2, -1, -1):
        prev = _select_row(backptr[t + 1], lab.clamp(min=0))
        lab = torch.where(li - 1 == t, final, torch.where(t < li - 1, prev, pad))
        paths[t] = lab
    return paths


def _lib_fn(name, n_ptrs):
    from ._build import load

    fn = getattr(load("viterbi"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(route, trans_t, inputs, li, outs):
    """Launch K10 on ``route`` with the outputs ``outs`` (backptr, d_end):
    ``viterbi_forward_{f32,f64}`` (the block route) or
    ``viterbi_forward_warp_{f32,f64}`` (the chain, then the backpointer
    pass over chunks of ``post_chunk`` frames, with a (T, B, N) scratch of
    the chain's rows between them)."""
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    ptrs = [trans_t, inputs, li, *outs]
    sizes = [t_total, num_batches, num_labels]
    if route == "warp":
        ptrs.append(torch.empty_like(inputs))
        sizes.append(post_chunk(t_total, num_batches))
    stem = "viterbi_forward_warp" if route == "warp" else "viterbi_forward"
    fn = c_function("viterbi", stem, dt, len(ptrs), len(sizes))
    with torch.cuda.device(dev):
        err = fn(*map(ptr, ptrs), *sizes, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def viterbi_forward_pallas(transition, inputs, input_lengths, *, route=None):
    """(d_end (B, N), backptr (T, B, N) int32): K10 on CUDA tensors, on
    ``route`` ('warp', 'block', or None for ``width_route`` of the label
    count), and its plain version on CPU ones.  backptr[t] maps the label
    AT frame t to the label at frame t-1 (frame 0 carries the identity
    row).  Both routes give the plain version's bits.

    Counts each launch in ``common.LAUNCHES`` as ``K10`` and ``K10.<route>``.
    """
    route = check_route("K10", route, inputs.shape[2])
    if not use_kernel(inputs, transition, input_lengths):
        return viterbi_forward_plain(transition, inputs, input_lengths)
    t_total, num_batches, num_labels = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"viterbi forward kernel takes float32 or float64, got {dt}")
    if num_labels > VITERBI_KERNEL_MAX_LABELS:
        raise ValueError(
            f"viterbi forward kernel takes num_labels <= "
            f"{VITERBI_KERNEL_MAX_LABELS}; got {num_labels}")
    trans_t = transition.to(dt).t().contiguous()
    li = input_lengths.to(torch.int32).contiguous()
    check_tensor("inputs", inputs, dt, (t_total, num_batches, num_labels), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    bp = torch.empty((t_total, num_batches, num_labels), dtype=torch.int32, device=dev)
    d_end = torch.empty((num_batches, num_labels), dtype=dt, device=dev)
    if bp.numel() == 0:
        return d_end.fill_(NEG_INF), bp
    _launch_fwd(route, trans_t, inputs, li, (bp, d_end))
    count_launch("K10", route)
    return d_end, bp


def _launch_backtrace(stem, route, rows, start, li, out):
    """Launch K11 (``stem`` 'viterbi_backtrace') or K13 ('align_backtrace')
    on ``route``: ``<stem>`` (the block route) or ``<stem>_warp`` (one warp
    per element); both take the same arguments."""
    t_total, num_batches, width = rows.shape
    fn = _lib_fn(f"{stem}_warp" if route == "warp" else stem, 4)
    with torch.cuda.device(rows.device):
        err = fn(ptr(rows), ptr(start), ptr(li), ptr(out), t_total, num_batches, width,
                 stream_ptr(rows.device))
    raise_on_error(fn.__name__, err)


def viterbi_backtrace_pallas(final_labels, backptr, input_lengths, *, route=None):
    """(T, B) int32 path from (T, B, N) backpointers, -1 past L_in: K11 on
    CUDA tensors, on ``route`` ('warp', 'block', or None for
    ``width_route`` of the label count), and its plain version on CPU ones.
    Final labels are taken as given, and backpointers read as given: a
    label outside [0, N) reads 0 at the frame before it (negative labels
    read column 0).  Both routes give the plain version's path.

    Counts each launch in ``common.LAUNCHES`` as ``K11`` and ``K11.<route>``.
    """
    route = check_route("K11", route, backptr.shape[2])
    if not use_kernel(backptr, final_labels, input_lengths):
        return viterbi_backtrace_plain(final_labels, backptr, input_lengths)
    t_total, num_batches, num_labels = backptr.shape
    dev = backptr.device
    fin = final_labels.to(torch.int32).contiguous()
    li = input_lengths.to(torch.int32).contiguous()
    check_tensor("backptr", backptr, torch.int32,
                 (t_total, num_batches, num_labels), dev)
    check_tensor("final_labels", fin, torch.int32, (num_batches,), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    paths = torch.empty((t_total, num_batches), dtype=torch.int32, device=dev)
    if paths.numel() == 0 or num_labels == 0:
        return paths.fill_(-1)
    _launch_backtrace("viterbi_backtrace", route, backptr, fin, li, paths)
    count_launch("K11", route)
    return paths


def _select_rows(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals[b, idx[b, r]]`` as (B, k), 0 where ``idx`` lies outside
    [0, M): the values the JAX package's one-hot select gives."""
    m = vals.shape[1]
    inside = (idx >= 0) & (idx < m)
    picked = torch.gather(vals, 1, idx.clamp(0, max(m - 1, 0)).long())
    return torch.where(inside, picked, torch.zeros_like(picked))


def _select_row(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals[b, idx[b]]`` as (B,): the k = 1 form of ``_select_rows``."""
    return _select_rows(vals, idx[:, None])[:, 0]


def align_forward_plain(lat, input_lengths):
    """Plain version of K12: (d_end (B, S), adv (T, B, S) int32) from an
    ``AlignedLattice``.  adv[t][b, s] == 1 iff the best path into frame t at
    slot s advanced from slot s - 1 (row 0 is a dummy 0)."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev = lat.inputs.device
    li = input_lengths.to(dev)
    adv = torch.zeros((t_total, num_batches, s_total), dtype=torch.int32, device=dev)
    d = torch.full((num_batches, s_total), NEG_INF, dtype=lat.inputs.dtype, device=dev)
    d[:, 0] = lat.inputs[0, :, 0]
    d_end = torch.where((li - 1 == 0)[:, None], d, NEG_INF)
    for t in range(1, t_total):
        stay = d + lat.self_trans
        move = _shift_right_s(d + lat.next_trans)
        d = lat.inputs[t] + torch.maximum(stay, move)
        adv[t] = move > stay
        d_end = torch.where((li - 1 == t)[:, None], d, d_end)
    return d_end, adv


def align_backtrace_plain(end_s, adv, input_lengths):
    """Plain version of K13 (both routes): (T, B) int32 target positions
    from the advance bits, -1 past L_in.  Frame L_in - 1 holds ``end_s`` as
    given; frame t before it holds p - adv[t + 1][b, p] with p =
    max(pos[t + 1], 0), or p where p is S or more."""
    t_total, num_batches, _ = adv.shape
    dev = adv.device
    end_t = input_lengths.to(dev) - 1
    end_s = end_s.to(device=dev, dtype=torch.int32)
    pad = torch.full_like(end_s, -1)
    positions = torch.empty((t_total, num_batches), dtype=torch.int32, device=dev)
    pos = torch.where(end_t == t_total - 1, end_s, pad)
    positions[t_total - 1] = pos
    for t in range(t_total - 2, -1, -1):
        prev = pos.clamp(min=0)
        prev = prev - _select_row(adv[t + 1], prev)
        pos = torch.where(end_t == t, end_s, torch.where(t < end_t, prev, pad))
        positions[t] = pos
    return positions


def _launch_align(route, lat, li, outs):
    """Launch K12 on ``route`` with the outputs ``outs`` (adv, d_end):
    ``align_forward_{f32,f64}`` (the block route) or
    ``align_forward_warp_{f32,f64}`` (one warp per element); both take the
    same arguments."""
    t_total, num_batches, s_total = lat.inputs.shape
    dev = lat.inputs.device
    stem = "align_forward_warp" if route == "warp" else "align_forward"
    fn = c_function("viterbi", stem, lat.inputs.dtype, 6, 3)
    with torch.cuda.device(dev):
        err = fn(ptr(lat.inputs), ptr(lat.self_trans), ptr(lat.next_trans), ptr(li),
                 *map(ptr, outs), t_total, num_batches, s_total, stream_ptr(dev))
    raise_on_error(fn.__name__, err)


def align_forward_pallas(lat, input_lengths, *, route=None):
    """(d_end (B, S), adv (T, B, S) int32) from an ``AlignedLattice``: K12 on
    CUDA tensors, on ``route`` ('warp', 'block', or None for
    ``width_route`` of the slot count), and its plain version on CPU ones.
    Both routes give the plain version's bits.  The warp route walks each
    element's chain only to row L_in, the last whose bits can be 1: it
    takes the emissions ``make_aligned`` gives, -inf from frame L_in on.

    Counts each launch in ``common.LAUNCHES`` as ``K12`` and ``K12.<route>``.
    """
    route = check_route("K12", route, lat.inputs.shape[2])
    if not use_kernel(lat.inputs, lat.self_trans, lat.next_trans, input_lengths):
        return align_forward_plain(lat, input_lengths)
    t_total, num_batches, s_total = lat.inputs.shape
    dev, dt = lat.inputs.device, lat.inputs.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"alignment forward kernel takes float32 or float64, got {dt}")
    if s_total > ALIGN_KERNEL_MAX_WIDTH:
        raise ValueError(
            f"alignment forward kernel takes s_total <= {ALIGN_KERNEL_MAX_WIDTH}; "
            f"got {s_total}")
    lat = AlignedLattice(lat.inputs.contiguous(), lat.self_trans.to(dt).contiguous(),
                         lat.next_trans.to(dt).contiguous(), lat.targets)
    li = input_lengths.to(torch.int32).contiguous()
    for name, t in (("self_trans", lat.self_trans), ("next_trans", lat.next_trans)):
        check_tensor(name, t, dt, (num_batches, s_total), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    adv = torch.empty((t_total, num_batches, s_total), dtype=torch.int32, device=dev)
    d_end = torch.empty((num_batches, s_total), dtype=dt, device=dev)
    if adv.numel() == 0:
        return d_end.fill_(NEG_INF), adv
    _launch_align(route, lat, li, (adv, d_end))
    count_launch("K12", route)
    return d_end, adv


def align_backtrace_pallas(end_s, adv, input_lengths, *, route=None):
    """(T, B) int32 target positions from (T, B, S) advance bits, -1 past
    L_in: K13 on CUDA tensors, on ``route`` ('warp', 'block', or None for
    ``width_route`` of the slot count), and its plain version on CPU ones.
    End slots are taken as given, and advance values are subtracted as
    given (not only 0 and 1): a position p reads adv[t + 1][max(p, 0)], or
    0 where that slot is S or more.  Both routes give the plain version's
    positions.

    Counts each launch in ``common.LAUNCHES`` as ``K13`` and ``K13.<route>``.
    """
    route = check_route("K13", route, adv.shape[2])
    if not use_kernel(adv, end_s, input_lengths):
        return align_backtrace_plain(end_s, adv, input_lengths)
    t_total, num_batches, s_total = adv.shape
    dev = adv.device
    es = end_s.to(torch.int32).contiguous()
    li = input_lengths.to(torch.int32).contiguous()
    check_tensor("adv", adv, torch.int32, (t_total, num_batches, s_total), dev)
    check_tensor("end_s", es, torch.int32, (num_batches,), dev)
    check_tensor("input_lengths", li, torch.int32, (num_batches,), dev)
    positions = torch.empty((t_total, num_batches), dtype=torch.int32, device=dev)
    if positions.numel() == 0 or s_total == 0:
        return positions.fill_(-1)
    _launch_backtrace("align_backtrace", route, adv, es, li, positions)
    count_launch("K13", route)
    return positions

