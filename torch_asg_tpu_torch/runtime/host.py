"""Host-side helpers of the serving path.

``collapse_path`` turns a framewise label path (a column of
``viterbi_decode``'s output) into a label sequence.  This is the NumPy form;
the native host runtime comes with the runtime slice.
"""

from __future__ import annotations

import numpy as np


def collapse_path(path, alphabet_size: int = 0, max_reps: int = 2) -> np.ndarray:
    """Drop -1 padding, merge runs of one label, and, when
    ``alphabet_size > 0``, expand the ``max_reps`` repeat symbols of the ASG
    extended alphabet (labels ``alphabet_size .. alphabet_size + max_reps - 1``
    stand for 1 .. max_reps repeats of the previous label).  With
    ``alphabet_size == 0`` it is a plain merge and ``max_reps`` is ignored.
    ``path`` may be a NumPy array or a tensor on any device."""
    if hasattr(path, "detach"):
        path = path.detach().cpu().numpy()
    out = []
    prev = -1
    for lab in np.asarray(path, np.int32).tolist():
        if lab < 0 or lab == prev:
            continue
        prev = lab
        if alphabet_size > 0 and alphabet_size <= lab < alphabet_size + max_reps:
            if out:
                out.extend([out[-1]] * (lab - alphabet_size + 1))
        else:
            out.append(lab)
    return np.asarray(out, np.int32)
