"""Mod-2^32 TCP sequence-number arithmetic (RFC 793 §3.3).

Reference: `src/lib/tcp/src/seq.rs` — a newtype over u32 with wrapping
comparison. Here sequence numbers are plain ints in [0, 2^32); comparisons
use the signed-difference trick so they are correct across wraparound as
long as the true distance is < 2^31.
"""

from __future__ import annotations

MOD = 1 << 32
HALF = 1 << 31

Seq = int  # alias for readability in signatures


def wrapping_add(a: Seq, n: int) -> Seq:
    return (a + n) % MOD


def seq_diff(a: Seq, b: Seq) -> int:
    """Signed distance a - b in (-2^31, 2^31]."""
    d = (a - b) % MOD
    return d - MOD if d >= HALF else d


def seq_lt(a: Seq, b: Seq) -> bool:
    return seq_diff(a, b) < 0


def seq_le(a: Seq, b: Seq) -> bool:
    return seq_diff(a, b) <= 0


def seq_gt(a: Seq, b: Seq) -> bool:
    return seq_diff(a, b) > 0


def seq_ge(a: Seq, b: Seq) -> bool:
    return seq_diff(a, b) >= 0


def seq_max(a: Seq, b: Seq) -> Seq:
    return a if seq_ge(a, b) else b


def seq_min(a: Seq, b: Seq) -> Seq:
    return a if seq_le(a, b) else b


def in_window(x: Seq, start: Seq, length: int) -> bool:
    """Is x in [start, start+length) with wraparound?"""
    return 0 <= seq_diff(x, start) < length if length > 0 else False
