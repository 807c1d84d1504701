"""Operator Launcher — faithful implementation of the paper's Algorithm 2.

Resource- and interference-aware launch ordering:

* keep two ready lists: memory-intensive ``L_mem`` and compute-intensive
  ``L_comp`` (classification from the Model Profiler);
* **alternate** between the two non-empty lists (interference-awareness —
  overlap compute-bound and memory-bound operators, paper Fig. 3);
* from the chosen list always launch the operator with the **least resource
  demand** (resource-awareness — avoid GPU blocking/fragmentation, Fig. 2);
* launching an op decrements successors' indegrees; newly-ready ops join the
  list matching their intensity class.

Baselines for the paper's figures:
* :func:`topo_order`       — stock framework order (paper's "CUDA Graph").
* :func:`depth_first_order`— Fig. 2 "order 1".
* :func:`resource_only_order` — ablation: smallest-first without alternation.
"""
from __future__ import annotations

import heapq

from .graph import IntensityClass, OpGraph
from .profiler import OpProfile


def opara_launch_order(graph: OpGraph, profiles: dict[int, OpProfile]) -> list[int]:
    """Algorithm 2, line-by-line (heaps instead of lists for O(n log n))."""
    indeg = graph.indegree_map()
    succ = graph.unique_successors_map()

    l_mem: list[tuple[float, int]] = []   # line 1: L_mem
    l_comp: list[tuple[float, int]] = []  # line 1: L_comp
    queue: list[int] = []                 # line 1: Q

    def push(i: int) -> None:
        demand = profiles[i].cost.resource_demand()
        if profiles[i].intensity is IntensityClass.MEMORY:
            heapq.heappush(l_mem, (demand, i))
        else:
            heapq.heappush(l_comp, (demand, i))

    for i, d in indeg.items():  # line 2: indegree-0 ops into L_mem / L_comp
        if d == 0:
            push(i)

    take_mem = True  # alternation state (line 4)
    while l_mem or l_comp:  # line 3
        # line 4: alternately choose a non-empty list
        if take_mem:
            lst = l_mem if l_mem else l_comp
        else:
            lst = l_comp if l_comp else l_mem
        take_mem = not take_mem
        _, v_min = heapq.heappop(lst)  # lines 5-6: least-resource op
        queue.append(v_min)
        for s in succ[v_min]:  # lines 7-16: update indegrees
            indeg[s] -= 1
            if indeg[s] == 0:
                push(s)
    assert len(queue) == len(graph), "launch order must cover every op"
    return queue


def topo_order(graph: OpGraph, profiles: dict[int, OpProfile] | None = None) -> list[int]:
    return graph.topological_order()


def depth_first_order(graph: OpGraph, profiles: dict[int, OpProfile] | None = None) -> list[int]:
    return graph.depth_first_order()


def resource_only_order(graph: OpGraph, profiles: dict[int, OpProfile]) -> list[int]:
    """Ablation: smallest-resource-first globally, ignoring intensity class."""
    indeg = graph.indegree_map()
    succ = graph.unique_successors_map()
    heap: list[tuple[float, int]] = []
    for i, d in indeg.items():
        if d == 0:
            heapq.heappush(heap, (profiles[i].cost.resource_demand(), i))
    out: list[int] = []
    while heap:
        _, i = heapq.heappop(heap)
        out.append(i)
        for s in succ[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, (profiles[s].cost.resource_demand(), s))
    return out


def largest_first_order(graph: OpGraph, profiles: dict[int, OpProfile]) -> list[int]:
    """Adversarial baseline: largest-resource-first (the GPU-blocking worst
    case the paper's Fig. 2 'inadequate order' represents)."""
    indeg = graph.indegree_map()
    succ = graph.unique_successors_map()
    heap: list[tuple[float, int]] = []
    for i, d in indeg.items():
        if d == 0:
            heapq.heappush(heap, (-profiles[i].cost.resource_demand(), i))
    out: list[int] = []
    while heap:
        _, i = heapq.heappop(heap)
        out.append(i)
        for s in succ[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, (-profiles[s].cost.resource_demand(), s))
    return out


def critical_path_order(graph: OpGraph, profiles: dict[int, OpProfile]) -> list[int]:
    """HEFT-style upward-rank order: among ready ops, launch the one with the
    longest remaining critical path (by ``est_us``) first.  A classic
    list-scheduling baseline the autotuner searches alongside Alg. 2 — it
    wins when the makespan is chain-dominated rather than interference- or
    resource-dominated."""
    succ = graph.unique_successors_map()
    rank: dict[int, float] = {}
    for i in reversed(graph.topological_order()):
        rank[i] = profiles[i].est_us + max(
            (rank[s] for s in succ[i]), default=0.0)
    indeg = graph.indegree_map()
    heap: list[tuple[float, int]] = []
    for i, d in indeg.items():
        if d == 0:
            heapq.heappush(heap, (-rank[i], i))
    out: list[int] = []
    while heap:
        _, i = heapq.heappop(heap)
        out.append(i)
        for s in succ[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, (-rank[s], s))
    return out


ORDER_POLICIES = {
    "opara": opara_launch_order,
    "topo": topo_order,
    "depth_first": depth_first_order,
    "resource_only": resource_only_order,
    "largest_first": largest_first_order,
    "critical_path": critical_path_order,
}


def validate_order(graph: OpGraph, order: list[int]) -> None:
    """Invariant: the order is a topological linearization covering all ops."""
    assert sorted(order) == sorted(graph.nodes), "order must be a permutation"
    pos = {i: k for k, i in enumerate(order)}
    for node in graph:
        for p in node.inputs:
            assert pos[p] < pos[node.op_id], (
                f"dependency violated: {p} after {node.op_id}")
