"""Wire-dtype verifier: the quantization claim checked in the collectives
that ran, the port's counterpart of
``ntxent_tpu/analysis/graph/wiredtype.py``.

The int8/bf16 collectives are verified by the mesh helpers' own
accounting: the same code that compresses a payload reports its wire
bytes, so a bug that left a payload in float32 would also report it
compressed. This verifier closes the loop from the other side: census
the gradient-reduce run (``census.CollectiveCensus`` sees the dtype of
every payload the dispatcher hands to ``c10d``) and FAIL if any
eligible-sized collective still carries float32 under an int8/bf16
policy. The dispatcher cannot lie about the tensors it was given.

Eligibility mirrors ``parallel/precision.py``: payloads under
``MIN_QUANT_ELEMS`` elements ride in full precision by design (the
int8 schedule's float32 scale columns are the canonical example), and
``pmax`` never quantizes (the census reads a MAX all-reduce's
``ReduceOp`` and names it ``pmax``). ``ppermute`` rides the policy too (the chunked
ring circulates embedding blocks hop by hop). What remains -- psum /
all_gather / psum_scatter / all_to_all / ppermute payloads at or above
the floor -- must be on the wire at the policy dtype.
"""

from __future__ import annotations

from ..framework import Finding

__all__ = ["ELIGIBLE_OPS", "ALLOWED_WIRE_DTYPES", "wire_dtype_findings"]

# Ops the precision policy compresses.
ELIGIBLE_OPS = ("psum", "all_gather", "psum_scatter", "all_to_all",
                "ppermute")

# Per policy: the dtypes a payload may legally occupy on the wire.
# float32 stays legal for int8's scale columns -- but scales sit far
# below the eligibility floor, which is what actually admits them.
ALLOWED_WIRE_DTYPES = {
    "int8": {"int8", "uint8", "bfloat16", "float16", "int32", "uint32",
             "bool"},
    "bf16": {"int8", "uint8", "bfloat16", "float16", "int32", "uint32",
             "bool"},
}


def wire_dtype_findings(entries, policy: str, target: str,
                        min_elems: int | None = None) -> list:
    """Findings for every census entry that should be compressed but
    is not. ``entries`` is a census of a run UNDER
    ``collective_precision(policy)``; ``target`` names the audited entry
    point (it becomes the finding's pseudo-path, so the baseline key
    stays stable across line churn the way lint findings do)."""
    if policy not in ALLOWED_WIRE_DTYPES:
        raise ValueError(f"policy must be one of "
                         f"{sorted(ALLOWED_WIRE_DTYPES)}, got {policy!r}")
    if min_elems is None:
        from ...parallel.precision import MIN_QUANT_ELEMS

        min_elems = MIN_QUANT_ELEMS
    allowed = ALLOWED_WIRE_DTYPES[policy]
    out = []
    for e in entries:
        if e.op not in ELIGIBLE_OPS:
            continue
        if e.nelems < min_elems:
            continue
        if e.dtype in allowed:
            continue
        out.append(Finding(
            rule="wire-dtype",
            path=f"graph://{target}",
            line=0,
            message=(
                f"{e.op} over axis {e.axis or '?'} carries "
                f"{e.dtype}[{','.join(map(str, e.shape))}] "
                f"({e.nelems} elems >= the {min_elems}-elem quantization "
                f"floor) on the wire under collective_precision"
                f"({policy!r}) — an uncompressed leak the host-side "
                f"accounting cannot see"),
            snippet=f"{e.op}|{e.axis}|{e.dtype}|"
                    f"{'x'.join(map(str, e.shape))}"))
    return out
