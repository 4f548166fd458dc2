"""FLOPs of the hand-written kernels, tallied where they launch.

``torch.utils.flop_counter.FlopCounterMode`` counts aten's matmuls and
convolutions (2 FLOPs a multiply-add, as XLA's cost analysis counts), but
a kernel launched through ``ctypes`` is no aten op and it sees nothing of
it. So each kernel wrapper of ``ops.ntxent``, ``ops.infonce`` and
``ops.attention`` adds its kernel's FLOPs here, beside its launch
counter, while a count is open (``counting()``); on a CPU tensor the
wrapper runs its plain version, whose aten ops the counter sees, and adds
nothing.

The formulas are those of the JAX kernels' ``pl.CostEstimate``
(``ntxent_pallas.py:222, 335, 427, 542, 639, 1149, 1275``,
``infonce_pallas.py:194, 299``, ``attention_pallas.py:502``) over the
logical (unpadded) shapes. #6 (``_bwd_general_call``) and #12-#14
(``flash_fold``, ``flash_dq_hop``, ``flash_dkv_hop``) carry no
CostEstimate, so XLA counts them as 0; here they count the products they
form: #6 rows and columns each s and one product (4 R C D each), #12 the
forward's 4 BH Lq Lk D, #13 s, dp and ds.k (6 BH Lq Lk D), #14 s, dp, dv
and dk (8 BH Lq Lk D). Masked (causal) tiles count as the plain version
counts them: in full.

The tally is process-wide, not per thread: on the card autograd runs a
backward on a device thread of its own, and #5, #13 and #14 launch there.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["Tally", "add", "counting", "flash_dkv", "flash_dq",
           "flash_fwd", "scores", "scores_and_product",
           "scores_and_products", "triangle_bwd", "triangle_fwd"]

_lock = threading.Lock()
_open: list["Tally"] = []


class Tally:
    """The kernel FLOPs added while it was open."""

    def __init__(self):
        self.flops = 0.0


def add(flops: float) -> None:
    """Add one launch's FLOPs to every open count (a no-op with none)."""
    if not _open:
        return
    with _lock:
        for tally in _open:
            tally.flops += flops


@contextlib.contextmanager
def counting():
    """``with counting() as tally:`` the kernels launched inside, on any
    thread, add their FLOPs to ``tally.flops``."""
    tally = Tally()
    with _lock:
        _open.append(tally)
    try:
        yield tally
    finally:
        with _lock:
            _open.remove(tally)


def scores(rows: int, cols: int, d: int) -> float:
    """s = z_rows z_cols^T once: #1 (``ntxent_pallas.py:222``) in every
    mode, #7 (``:1149``), #9 (``infonce_pallas.py:194``) square and
    rectangular."""
    return 2.0 * rows * cols * d


def scores_and_product(rows: int, cols: int, d: int) -> float:
    """s and one product with it: #5 (``:639``) symmetric and
    cross-modal, #4 (``:542``), #6's rows and columns kernels each."""
    return 4.0 * rows * cols * d


def scores_and_products(rows: int, cols: int, d: int) -> float:
    """s and both products: #10 (``infonce_pallas.py:299``), #8
    (``:1275``)."""
    return 6.0 * rows * cols * d


def triangle_fwd(rows: int, d: int) -> float:
    """#2 (``:335``): the upper triangle of s, half the square's."""
    return float(rows) * rows * d


def triangle_bwd(rows: int, d: int) -> float:
    """#3 (``:427``): the triangle of s, the direct and the transposed
    product."""
    return 3.0 * rows * rows * d


def flash_fwd(bh: int, lq: int, lk: int, d: int) -> float:
    """#11 (``attention_pallas.py:502``) and #12: q.k^T and p.v."""
    return 4.0 * bh * lq * lk * d


def flash_dq(bh: int, lq: int, lk: int, d: int) -> float:
    """#13: s, dp = dO.v^T and dq = ds.k."""
    return 6.0 * bh * lq * lk * d


def flash_dkv(bh: int, lq: int, lk: int, d: int) -> float:
    """#14: s, dp, dv = p^T.dO and dk = ds^T.q."""
    return 8.0 * bh * lq * lk * d
