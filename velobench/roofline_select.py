"""The least time of a ``scan_select`` launch, for its roofline share: the
bytes a launch must move at the HBM rate (``roofline.HBM_BYTES_PER_S``).
Its operations (~20 an entry on the CUDA cores) take a fraction of that
time at the fp32 peak, so the bound is by bytes."""

from __future__ import annotations

from velobench import roofline


def scan_select_bytes(B: int, L: int, C: int, carried: bool) -> int:
    """One inner-product launch over a chunk of L rows for B queries keeping
    C: the (B, L) fp32 product read once, the rows' 8-byte table entries (the
    fp32 reciprocal and the bf16 pair), the query table (one bf16 a query),
    the carry of bf16 values and int64 ids read (where there is one) and the
    new one written.  The rows' bf16 ``ipb``, read only where a quotient
    needs the IEEE division, is not counted."""
    carry = B * C * (2 + 8)
    return B * L * 4 + L * 8 + B * 2 + carry * (2 if carried else 1)


def scan_select_bound_s(B: int, L: int, C: int, carried: bool) -> float:
    return scan_select_bytes(B, L, C, carried) / roofline.HBM_BYTES_PER_S
