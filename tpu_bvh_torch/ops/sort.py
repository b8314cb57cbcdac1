"""Key-value sort of (Morton code, primitive index) pairs, the port of
`tpu_bvh.ops.sort`.

JAX sorts the two keys (u32 code, i32 value) with `lax.sort`; here the
pair is packed into one int64 key, high word the code biased by -2^31
(so the signed order of the key is the unsigned order of the code),
low word the value biased by +2^31 (its signed order), and `torch.sort`
sorts that once on either device. Codes may come as int64 holding u32
values (the port's Morton codes) or as int32 holding u32 bits: only the
low 32 bits are read, so a code >= 2^31 sorts above every smaller one
either way. With unique values the key is unique and the order total.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_BIAS = 1 << 31


def _packed_key(codes, values):
    hi = (codes.to(torch.int64) & M32) - _BIAS
    return hi * (1 << 32) + (values.to(torch.int64) + _BIAS)


def sort_pairs(codes, values):
    """Ascending sort by (codes, values), a total order when `values` are
    unique (prim indices). codes: [n] u32 values (int64 or int32 bits),
    values: i32[n]. Returns (sorted codes in the dtype of `codes`,
    sorted values i32)."""
    key, _ = torch.sort(_packed_key(codes, values))
    sc = (key >> 32) + _BIAS
    sv = (key & M32) - _BIAS
    if codes.dtype == torch.int32:  # back to u32 bits in i32
        sc = torch.where(sc >= _BIAS, sc - (1 << 32), sc)
    return sc.to(codes.dtype), sv.to(values.dtype)


def sort_with_payload(codes, payload):
    """Ascending sort of `codes` carrying a tuple of payload tensors;
    payload[0] must be a unique index channel, the tiebreak key, so the
    order is the canonical (code, index) total order. Returns
    (sorted_codes, tuple(sorted_payload))."""
    _, order = torch.sort(_packed_key(codes, payload[0]))
    return codes[order], tuple(p[order] for p in payload)
