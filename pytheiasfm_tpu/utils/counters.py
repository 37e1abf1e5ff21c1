"""Device-launch accounting.

Each synchronized dispatch has a fixed host cost (dispatch, a blocking
transfer), so pipeline wall-clock at small problem sizes (fountain-11) is
a LAUNCH-COUNT budget as much as a FLOP budget. The hot paths bump a
named counter per device launch; pipelines snapshot the
counters per phase to make regressions visible. The matcher also records
which implementation it chose (`matcher_triton` / `matcher_xla`).

This counts the launches the framework issues deliberately (kernel
launches, chunk loops, batched solvers) — incidental jnp ops on host paths
are kept off the hot paths by design (see ops/rotation_np.py).
"""

from __future__ import annotations

from collections import Counter

__all__ = ["bump", "reset", "snapshot", "total"]

_counts: Counter = Counter()


def bump(name: str, n: int = 1) -> None:
    _counts[name] += n


def reset() -> None:
    _counts.clear()


def snapshot() -> dict:
    return dict(_counts)


def total() -> int:
    return sum(_counts.values())
