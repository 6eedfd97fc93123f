"""Length bucketing (a copy of piper_tpu/runtime/batching.py) and the
decode planner.

Padding phoneme rows to a small geometric ladder of lengths keeps the
set of batch shapes small while keeping padding waste low. The
reference has no batching at all (batch=1 serial loop, piper.cpp:484).

plan_decode_groups and round_rows are TpuVoice._plan_decode_groups and
TpuVoice._round_rows (piper_tpu/runtime/voice.py:616-640) as functions:
how one encode group's rows split into decodes, each at one frame
bucket.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def bucket_ladder(min_size: int, max_size: int, growth: float = 1.5) -> List[int]:
    """Geometric ladder of bucket sizes, multiples of 16."""
    sizes = []
    s = float(min_size)
    while True:
        size = min(int(-(-s // 16) * 16), max_size)
        if not sizes or size > sizes[-1]:
            sizes.append(size)
        if size >= max_size:
            break
        s *= growth
    return sizes


DEFAULT_PHONEME_BUCKETS = bucket_ladder(32, 512)
DEFAULT_FRAME_BUCKETS = bucket_ladder(128, 4096)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"length {length} exceeds the largest bucket {buckets[-1]}; "
        "split the input (sentence/phrase segmentation) or raise max bucket"
    )


def group_by_bucket(
    lengths: Sequence[int], buckets: Sequence[int]
) -> List[Tuple[int, List[int]]]:
    """Group item indices by their padded bucket size.

    Returns [(bucket_size, [indices])], preserving input order inside
    each group.
    """
    groups: dict = {}
    for i, l in enumerate(lengths):
        b = pick_bucket(l, buckets)
        groups.setdefault(b, []).append(i)
    return sorted(groups.items())


def plan_packed_groups(
    lengths: Sequence[int],
    buckets: Sequence[int],
    round_rows=lambda n: n,
    dispatch_cost: int = 512,
) -> List[Tuple[int, List[int]]]:
    """Partition rows into decode groups minimizing total padded
    compute (sum over groups of round_rows(|group|) * bucket(max)),
    plus `dispatch_cost` row-frames per group for the fixed launch
    overhead.

    Rows are sorted by length (desc); an optimal partition is then a
    set of contiguous segments of that order (any group's cost is set
    by its longest row, so swapping a longer row into a later group
    never helps) — found by an O(n^2) DP. `round_rows` mirrors the
    caller's jit row-count rounding (e.g. next power of two) so the
    cost model prices exactly what the device will execute, and every
    group lands on a (rounded rows x bucket) shape the warmup already
    compiled.

    Against one-bucket-per-batch ("uniform") this removes the
    short-rows-decoded-at-the-longest-row's-bucket waste (measured
    2.2x padded-vs-true frames on the bench batch); against plain
    per-bucket grouping ("bucketed") it merges small neighbor groups
    when the row-count rounding or dispatch cost makes a shared,
    taller decode cheaper. Returns [(bucket, [original indices])].
    """
    n = len(lengths)
    if n == 0:
        return []
    order = sorted(range(n), key=lambda i: (-int(lengths[i]), i))
    inf = float("inf")
    best = [0.0] + [inf] * n
    cut = [0] * (n + 1)
    for j in range(1, n + 1):
        for i in range(j):
            b = pick_bucket(int(lengths[order[i]]), buckets)
            c = best[i] + round_rows(j - i) * b + dispatch_cost
            if c < best[j]:
                best[j] = c
                cut[j] = i
    segs = []
    j = n
    while j > 0:
        i = cut[j]
        segs.append((i, j))
        j = i
    return [
        (pick_bucket(int(lengths[order[i]]), buckets), order[i:j])
        for i, j in reversed(segs)
    ]


DECODE_GROUPINGS = ("bucketed", "uniform", "packed")


def round_rows(n: int, data: int = 1) -> int:
    """A group's row count rounded up to a power of two, and to a
    multiple of the data-axis size (TpuVoice._round_rows, voice.py:
    633-641): the rows a decode pads to, and so what it costs."""
    p = 1
    while p < n:
        p <<= 1
    return -(-p // data) * data


def plan_decode_groups(
    frame_counts: Sequence[int],
    grouping: str,
    frame_buckets: Sequence[int],
    data: int = 1,
) -> List[Tuple[int, List[int]]]:
    """[(frame_bucket, row_positions)] for one encode group's rows:
    "uniform" one decode at the bucket of the longest row; "bucketed"
    one decode per frame bucket; "packed" plan_packed_groups' partition.
    Every count must fit the ladder (pick_bucket raises past it);
    `data`: the data-axis size a decode's rows pad to (round_rows)."""
    counts = [int(f) for f in frame_counts]
    if grouping == "uniform":
        return [(pick_bucket(max(counts), frame_buckets), list(range(len(counts))))]
    if grouping == "packed":
        return plan_packed_groups(counts, frame_buckets, round_rows=lambda n: round_rows(n, data))
    if grouping == "bucketed":
        return group_by_bucket(counts, frame_buckets)
    raise ValueError(f"decode_grouping: {grouping!r}")
