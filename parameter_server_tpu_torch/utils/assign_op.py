"""Assignment operators of pushes and merges (host, numpy).

Counterpart of ``parameter_server_tpu/utils/assign_op.py`` (the
reference's ``AssignOpType`` and ``AssignFunc``): ASSIGN, PLUS, MINUS,
TIMES, DIVIDE and the logical AND, OR, XOR. Pushes add (PLUS), pulls
assign.
"""

from __future__ import annotations

import enum

import numpy as np


class AssignOp(enum.Enum):
    ASSIGN = "assign"
    PLUS = "plus"
    MINUS = "minus"
    TIMES = "times"
    DIVIDE = "divide"
    AND = "and"
    OR = "or"
    XOR = "xor"


_APPLY = {
    AssignOp.ASSIGN: lambda dst, src: src,
    AssignOp.PLUS: lambda dst, src: dst + src,
    AssignOp.MINUS: lambda dst, src: dst - src,
    AssignOp.TIMES: lambda dst, src: dst * src,
    AssignOp.DIVIDE: lambda dst, src: dst / src,
    AssignOp.AND: np.logical_and,
    AssignOp.OR: np.logical_or,
    AssignOp.XOR: np.logical_xor,
}


def apply_op(op: AssignOp, dst, src):
    """``dst op src`` (``src`` itself for ASSIGN)."""
    try:
        fn = _APPLY[op]
    except (KeyError, TypeError):
        raise ValueError(f"unknown op {op}") from None
    return fn(dst, src)
