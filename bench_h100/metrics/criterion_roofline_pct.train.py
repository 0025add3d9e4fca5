"""criterion_roofline_pct.train: the least time of ASG forward and
backward at the window's shapes (``work.criterion_work``, the same for
every tier) over the device time of the kernels launched by the
criterion's autograd functions, forward and backward, in percent."""

from bench_h100 import work

# the autograd functions of the fused, matmul, per-lattice and scan tiers
FUNCTIONS = ("_FusedScores", "_FccMatmul", "_FacScore", "_FccScore", "_FccPallas",
             "_FacPallas")
OPS = FUNCTIONS + tuple(f + "Backward" for f in FUNCTIONS)


def read(out):
    if not out.traces or not out.facts.get("criterion_ops"):
        return None
    ns = out.traces[0].device_ns(OPS)
    if not ns:
        return None
    least = work.bound_s(out.facts["criterion_ops"], out.facts["criterion_bytes"])
    return 100.0 * least / (ns / 1e9)
