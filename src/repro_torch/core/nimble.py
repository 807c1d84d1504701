"""Nimble baseline [Kwon et al., NeurIPS'20] — stream assignment via
minimum-path-cover / bipartite maximum matching.

The paper (§5, Table 1) compares against Nimble, which "transforms the
computation graph into a bipartite graph and then identifies its maximum
matching to determine an appropriate stream for each operator".  A minimum
path cover of the DAG (streams = vertex-disjoint paths) equals
|V| − |maximum matching| on the bipartite split graph (König/Dilworth).
Nimble applies this to the *transitive reduction*; combined with matching on
the (transitively closed) graph the cost is O(n^3) — which is exactly the
complexity gap Table 1 measures against Opara's O(n) Alg. 1.

We implement Hopcroft–Karp on the closure for fidelity to Nimble's claimed
behaviour (fewer streams, i.e. minimum lanes) and to reproduce Table 1's
runtime gap.
"""
from __future__ import annotations

from collections import deque

from .graph import OpGraph
from .stream_alloc import StreamPlan

_INF = float("inf")


def _transitive_closure(graph: OpGraph) -> dict[int, set[int]]:
    """Reachability sets via reverse-topological DP (O(V·E) bitset-ish)."""
    succ = graph.unique_successors_map()
    order = graph.topological_order()
    reach: dict[int, set[int]] = {}
    for i in reversed(order):
        r: set[int] = set()
        for s in succ[i]:
            r.add(s)
            r |= reach[s]
        reach[i] = r
    return reach


def _hopcroft_karp(adj: dict[int, list[int]], left: list[int]) -> dict[int, int]:
    """Maximum bipartite matching; returns match_left: u -> v."""
    match_l: dict[int, int | None] = {u: None for u in left}
    match_r: dict[int, int | None] = {}

    def bfs() -> bool:
        dist: dict[int, float] = {}
        q: deque[int] = deque()
        for u in left:
            if match_l[u] is None:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = _INF
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_r.get(v)
                if w is None:
                    found = True
                elif dist.get(w, _INF) is _INF:
                    dist[w] = dist[u] + 1
                    q.append(w)
        bfs.dist = dist  # type: ignore[attr-defined]
        return found

    def dfs(u: int) -> bool:
        dist = bfs.dist  # type: ignore[attr-defined]
        for v in adj[u]:
            w = match_r.get(v)
            if w is None or (dist.get(w, _INF) == dist[u] + 1 and dfs(w)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = _INF
        return False

    while bfs():
        for u in left:
            if match_l[u] is None:
                dfs(u)
    return {u: v for u, v in match_l.items() if v is not None}


def allocate_streams_nimble(graph: OpGraph, use_closure: bool = True) -> StreamPlan:
    """Minimum path cover stream assignment (Nimble's scheme).

    With ``use_closure=True`` paths may "jump over" intermediate nodes
    (Dilworth chains — minimum number of streams = max antichain); this is
    the O(n^3)-ish variant whose cost Table 1 reports.
    """
    ids = list(graph.nodes)
    if use_closure:
        reach = _transitive_closure(graph)
        adj = {u: sorted(reach[u]) for u in ids}
    else:
        succ = graph.unique_successors_map()
        adj = {u: sorted(succ[u]) for u in ids}

    match = _hopcroft_karp(adj, ids)

    # chains: follow matched edges from unmatched-on-the-right starts
    matched_right = set(match.values())
    stream_of: dict[int, int] = {}
    n_streams = 0
    for u in sorted(ids):
        if u in matched_right:
            continue  # not a chain head
        s = n_streams
        n_streams += 1
        cur: int | None = u
        while cur is not None:
            stream_of[cur] = s
            cur = match.get(cur)
    # isolated safety: anything missed gets its own stream
    for u in ids:
        if u not in stream_of:
            stream_of[u] = n_streams
            n_streams += 1
    return StreamPlan(stream_of=stream_of, n_streams=n_streams)
