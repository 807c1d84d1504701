"""CUDA-graph capture against Python's cyclic garbage collector, on the card.

A graph dropped in a reference cycle (an engine, say) is freed whenever the
collector runs; freed while another stream is capturing, it invalidates that
capture.  :class:`repro_torch.core.capture.CudaGraphReplay` therefore keeps
the collector out of its capture.  Needs a Hopper CUDA card and skips
without one; imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_capture.py
"""
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.capture import CudaGraphReplay  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_a_graph_dropped_during_a_capture_does_not_invalidate_it(cuda):
    x = torch.arange(8.0, device=cuda)
    cycle = {}
    cycle["self"] = cycle
    cycle["graph"] = CudaGraphReplay(lambda a: [a * 2], [x])
    box = [cycle]
    del cycle
    calls = []

    def walk(a):
        calls.append(len(calls))
        if len(calls) == 2:                 # the recorded call
            box.clear()                     # the cycle and its graph die
            junk = [[] for _ in range(10_000)]  # the collector's trigger
            del junk
        return [a + 1]

    threshold = gc.get_threshold()
    gc.set_threshold(10, 2, 2)
    try:
        replay = CudaGraphReplay(walk, [x])
    finally:
        gc.set_threshold(*threshold)
    assert calls == [0, 1]
    assert torch.equal(replay([x])[0], x + 1)
