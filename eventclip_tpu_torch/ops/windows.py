"""Event-count window arithmetic.

Behavioral contract (reference: datasets/vis.py:55-72 `split_event_count`):
an event stream of `n` events is split into consecutive windows of exactly
`N` events; if the remainder past the last full boundary is more than half a
window, one extra *tail* window covering the final `N` events (overlapping
the previous one) is appended; a stream shorter than `N` yields a single
window containing everything.

This module is pure index arithmetic (host-side, numpy-free) so the data
pipeline can gather exactly the selected windows before transfer; the raster
kernel itself never sees the full stream. A copy of
eventclip_tpu/ops/windows.py (tests/test_torch_host.py pins it equal).
"""

from __future__ import annotations

from typing import List, Tuple


def num_windows(n: int, N: int) -> int:
    """Number of frames produced for an n-event stream with window size N."""
    if n < N:
        return 1
    # number of boundary points laid down every N events, starting at 0,
    # strictly below n  ->  q = ceil(n / N)
    q = -(-n // N)
    full = q - 1
    rem = n - full * N  # in (0, N]
    return full + (1 if 2 * rem > N else 0)


def event_count_windows(n: int, N: int) -> List[Tuple[int, int]]:
    """[(start, end)] index ranges of each window, reference-ordered."""
    if n < N:
        return [(0, n)]
    q = -(-n // N)
    spans = [(k * N, (k + 1) * N) for k in range(q - 1)]
    rem = n - (q - 1) * N
    if 2 * rem > N:
        spans.append((n - N, n))
    return spans
