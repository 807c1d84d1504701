"""Stream Allocator — faithful implementation of the paper's Algorithm 1.

Key idea (paper §3.1): allocate parallelizable operators to as many streams
as possible (minimize ``h(A)``) while chaining each operator onto the stream
of a predecessor whenever it is that predecessor's *first* successor, so the
number of cross-stream synchronizations stays low (minimize ``g(A)``).

Complexity: O(|V| · max_width) ≈ O(n) since DAG width is small (paper §5.3).

On TPU a "stream" is an execution lane (DESIGN.md §2): ops in one lane are
totally ordered; ops in different lanes may be packed into the same wave by
the capturer.  Cross-lane edges are exactly the events/waits the paper counts
as synchronization overhead, so we expose :func:`count_syncs` for the
``g(A)`` proxy used in benchmarks.
"""
from __future__ import annotations

import dataclasses

from .graph import OpGraph


@dataclasses.dataclass
class StreamPlan:
    """Result of stream allocation.

    stream_of: op_id -> stream index (0-based).
    n_streams: total streams launched.
    """

    stream_of: dict[int, int]
    n_streams: int

    def ops_in_stream(self, s: int) -> list[int]:
        return sorted(i for i, v in self.stream_of.items() if v == s)


def allocate_streams(graph: OpGraph) -> StreamPlan:
    """Algorithm 1, line-by-line.

    Iterate operators in topological (insertion) order; for each operator v,
    scan its predecessors p: if v is p's first successor, inherit p's stream;
    otherwise open a fresh stream.
    """
    # first_successor[p] = the successor of p with the smallest topological
    # position (the paper's "first successor" — first in enumeration order).
    first_successor: dict[int, int] = {}
    order = graph.topological_order()
    pos = {i: k for k, i in enumerate(order)}
    for i in order:
        for p in graph.nodes[i].inputs:
            cur = first_successor.get(p)
            if cur is None or pos[i] < pos[cur]:
                first_successor[p] = i

    stream_of: dict[int, int] = {}
    n_streams = 0
    for v in order:  # line 2: enumerate in topological sorting order
        node = graph.nodes[v]
        assigned = False
        for p in node.inputs:  # line 3: iterate predecessors
            if first_successor.get(p) == v:  # line 4: v is first successor
                stream_of[v] = stream_of[p]  # line 5: same stream as p
                assigned = True
                break  # line 6
        if not assigned:  # lines 9-11: new stream
            stream_of[v] = n_streams
            n_streams += 1
    return StreamPlan(stream_of=stream_of, n_streams=n_streams)


def count_syncs(graph: OpGraph, plan: StreamPlan) -> int:
    """Number of cross-stream dependency edges = event/wait pairs that the
    Graph Capturer must insert (the paper's g(A) proxy)."""
    syncs = 0
    for node in graph:
        for p in set(node.inputs):
            if plan.stream_of[p] != plan.stream_of[node.op_id]:
                syncs += 1
    return syncs


def validate_plan(graph: OpGraph, plan: StreamPlan) -> None:
    """Invariants under test (hypothesis):
    * every op is assigned to exactly one stream (paper constraint Eq. 5);
    * ops sharing a stream are totally ordered by dependencies OR by
      topological position (streams are FIFO queues — no reordering);
    * stream count never exceeds |V| and is >= max antichain that uses roots.
    """
    assert set(plan.stream_of) == set(graph.nodes), "every op exactly one stream"
    assert 0 < plan.n_streams <= max(1, len(graph))
    for s in range(plan.n_streams):
        ops = plan.ops_in_stream(s)
        assert ops == sorted(ops)
