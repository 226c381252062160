"""Shape bucketing for the serving path.

The port's own copy of ``bucket_sizes``/``bucket_for`` from
``deeplearning4j_tpu/datasets/iterators.py``; the iterators themselves
wait for ROADMAP Queue A9.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; an oversized n passes through unpadded."""
    for b in buckets:
        if n <= b:
            return b
    return n
