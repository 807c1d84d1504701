"""The page pool's fault sites at each of their activations, against the
JAX package's engine.

``page_alloc`` and ``page_release`` are faulted at their k-th activation
alone, for every k over the fault-free paged burst trace and a one-slot
paged trace whose long request is preempted and resumes from its kept
pages, which together reach all three ``page_alloc`` call sites (admission,
resume, a decode tick's growth) and every terminal release.  Both engines
(Llama-3.2-1B's smoke model, fp32, the reference's params bridged) must
agree on every request's state and tokens, ``fault_stats``, the tick count
and the pool's books, and the books must balance after the pages of a
cleared slot come back (a failed release leaks, counted).
"""
import functools
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_engine_faults import (_pair, _run, chaos,  # noqa: E402
                                      port_faults)


def _paged_resume_run(api, model, params, shape, fault_plan=None):
    """One slot, paged: a long request is preempted by a deadline-critical
    one and resumes from its kept pages (the resume call site)."""
    engine = api.InferenceEngine(
        model, params, max_slots=1, max_len=32, seed=5, paged_kv=True,
        page_size=4, admission=api.AdmissionConfig(policy="edf",
                                                   preemption=True),
        fault_plan=fault_plan)
    low = api.Request(rid="low", prompt=[5, 6, 7], max_tokens=12)
    engine.submit(low)
    for _ in range(4):
        engine.step()
    hi = api.Request(rid="hi", prompt=[9, 9], max_tokens=3, priority=3, ttl=4)
    engine.submit(hi)
    engine.run(200)
    return engine, {"low": low, "hi": hi}


def _kth_fault(site: str, k: int, callers: list | None = None):
    """A plan (for either package) that raises at ``site``'s k-th
    activation only, recording the engine method of every activation."""
    def make(mod):
        class KthFault(mod.FaultPlan):
            def __init__(self):
                super().__init__([mod.FaultSpec(site=site)])
                self.seen = 0

            def fire(self, s, payload=None):
                if s != site:
                    return payload
                self.seen += 1
                if callers is not None and mod is port_faults:
                    callers.append(sys._getframe(1).f_code.co_name)
                if self.seen == k:
                    self.fired[s] += 1
                    raise mod.FaultInjected(s)
                return payload
        return KthFault()
    return make


@functools.lru_cache(maxsize=None)
def _activations(site: str, trace_name: str) -> tuple:
    trace = (_paged_resume_run if trace_name == "resume"
             else chaos.TRACES[trace_name])
    callers: list = []
    _run("port", trace, _kth_fault(site, 0, callers)(port_faults))
    return tuple(callers)


# activations of each page site over the fault-free traces, in program order
PAGE_ACTIVATIONS = {("page_alloc", "paged"): 16, ("page_alloc", "resume"): 12,
                    ("page_release", "paged"): 4}


def test_every_page_alloc_call_site_is_reached():
    for (site, trace_name), n in PAGE_ACTIVATIONS.items():
        assert len(_activations(site, trace_name)) == n
    sites = set(_activations("page_alloc", "paged")) | set(
        _activations("page_alloc", "resume"))
    assert sites == {"_admit_paged", "_resume_paged", "_paged_decode_tick"}


@pytest.mark.parametrize("site,trace_name,k", [
    (site, trace_name, k) for (site, trace_name), n in PAGE_ACTIVATIONS.items()
    for k in range(1, n + 1)])
def test_a_fault_at_each_page_activation_as_the_reference(site, trace_name, k):
    """The fault lands on the k-th activation: an admission, a resume or
    a tick's growth (``page_alloc``), a terminal release (``page_release``);
    the engines must agree and the books balance after the pages of a
    cleared slot come back."""
    trace = (_paged_resume_run if trace_name == "resume"
             else chaos.TRACES[trace_name])
    engine, done = _pair(trace, make_plan=_kth_fault(site, k))
    chaos.check_all_terminal(engine, done, site)
    assert engine.fault_stats[chaos.SITE_COUNTER[site]] == 1
    leaked = chaos.check_pool_books(engine, site)
    assert (leaked >= 1) == (site == "page_release")
