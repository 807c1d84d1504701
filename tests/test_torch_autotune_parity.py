"""The autotuner's pick on the DeepSeek-V3 routed op graph, port against
reference, under identical injected per-op times.

Both packages' ``autotune`` rank the same {alloc} x {order} x {repack}
candidates on the same cost model, so with the same measured times applied
to structurally equal graphs they must pick the same (alloc, order,
repack), estimate the same makespan and fuse the same GEMM groups.  The
times are a fixed profile (the analytic per-op estimates on the H100's
spec) and copies of it perturbed by +-5% from a numpy seed, the spread of
a short calibration on the card.  The full-width cost-only graph also pins
why a fusion-free pick can happen at all: there every repacked candidate
gives each expert GEMM a wave of its own and fuses nothing, while the
plain candidates fuse 4 groups, and the two kinds' estimates lie within a
fraction of a percent of each other.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import profiler as ref_profiler  # noqa: E402
from repro.core import scheduler as ref_scheduler  # noqa: E402
from repro.core import simulator as ref_simulator  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import profiler as port_profiler  # noqa: E402
from repro_torch.core import scheduler as port_scheduler  # noqa: E402
from repro_torch.core import simulator as port_simulator  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402

ARCH = "deepseek-v3-671b"
HW = port_profiler.H100_SXM
REF_HW = ref_profiler.HardwareSpec(**dataclasses.asdict(HW))
PERTURBED = (1, 2, 3, 4)       # seeds of the +-5% copies; 0 is the fixed one


@pytest.fixture(scope="module")
def smoke_pair():
    """The smoke-config routed graph (4 layers, batch 1, seq 16) with
    payloads, built from one param tree in both packages."""
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True),
                               dtype=jax.numpy.float32)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype=torch.float32)
    rparams = RefModel(rcfg).init(jax.random.key(0))
    tparams = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                "cpu")
    return (ref_export(rcfg, batch=1, seq=16, params=rparams, n_layers=4),
            build_lm_opgraph(cfg, batch=1, seq=16, params=tparams,
                             n_layers=4))


def _profile(pg, seed: int) -> tuple:
    """(op_id, µs) for every op with a payload or a cost: the analytic
    estimate on the H100 spec, times 1 +- 5% uniform noise unless seed 0."""
    prof = port_profiler.ModelProfiler(HW).profile(pg)
    rng = np.random.default_rng(seed)
    rows = []
    for op_id in sorted(prof):
        us = prof[op_id].est_us
        if seed:
            us *= 1.0 + rng.uniform(-0.05, 0.05)
        rows.append((op_id, float(us)))
    return tuple(rows)


def _tune_both(rg, pg, seed: int):
    table = _profile(pg, seed)
    ref_profiler.apply_profile(rg, ref_profiler.ProfileTable(HW.name, table))
    port_profiler.apply_profile(pg, port_profiler.ProfileTable(HW.name,
                                                               table))
    rp = ref_scheduler.autotune(
        rg, hw=REF_HW, cfg=ref_simulator.SimConfig(head_of_line=True))
    pp = port_scheduler.autotune(
        pg, hw=HW, cfg=port_simulator.SimConfig(head_of_line=True))
    return rp, pp


def _groups(plan) -> list:
    return [(w.index, tuple(g)) for w in plan.waves.waves
            for g in w.fusion_groups if len(g) > 1]


def _same_pick(rp, pp) -> None:
    assert (pp.alloc_policy, pp.order_policy, pp.repacked) == \
        (rp.alloc_policy, rp.order_policy, rp.repacked)
    assert pp.est_makespan_us == rp.est_makespan_us
    assert pp.n_candidates == rp.n_candidates == len(pp.candidates)
    # the logged candidate rows hold the pick's estimate as their minimum
    assert min(est for *_, est in pp.candidates) == pp.est_makespan_us
    assert pp.order == rp.order
    assert _groups(pp) == _groups(rp)


@pytest.mark.parametrize("seed", (0,) + PERTURBED)
def test_smoke_graph_autotune_picks_and_fuses_alike(smoke_pair, seed):
    rg, pg = smoke_pair
    rp, pp = _tune_both(rg, pg, seed)
    _same_pick(rp, pp)
    port_stats = port_scheduler.compile_plan(pp).program_stats()
    ref_stats = ref_scheduler.compile_plan(
        rp, gemm_kernel="pallas").program_stats()
    assert port_stats == ref_stats
    assert port_stats["n_branch_gemm"] + port_stats["n_grouped_gemm"] > 0


@pytest.fixture(scope="module")
def full_width_pair():
    """Phase 9's graph without payloads: full width, 4 layers, seq 512."""
    rcfg = dataclasses.replace(ref_config(ARCH), n_layers=4)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=4)
    return (ref_export(rcfg, batch=1, seq=512),
            build_lm_opgraph(cfg, batch=1, seq=512))


@pytest.mark.parametrize("seed", (0,) + PERTURBED)
def test_full_width_graph_autotune_picks_alike(full_width_pair, seed):
    rg, pg = full_width_pair
    rp, pp = _tune_both(rg, pg, seed)
    _same_pick(rp, pp)


def test_full_width_repacked_candidates_fuse_nothing(full_width_pair):
    """C17's mechanism: the near-tie between fusing and fusion-free
    candidates that measured calibration noise can flip."""
    rg, pg = full_width_pair
    table = _profile(pg, 0)
    port_profiler.apply_profile(pg, port_profiler.ProfileTable(HW.name,
                                                               table))
    cfg = port_simulator.SimConfig(head_of_line=True)
    ests = {}
    for alloc in ("opara", "nimble"):
        for order in ("opara", "topo", "critical_path"):
            for repack in (False, True):
                plan = port_scheduler.schedule(pg, alloc, order, hw=HW,
                                               repack=repack, sim_cfg=cfg)
                assert bool(_groups(plan)) is not repack, (alloc, order)
                ests[repack] = min(ests.get(repack, float("inf")),
                                   port_scheduler.estimate_plan(plan, cfg))
    assert abs(ests[True] - ests[False]) < 0.01 * ests[False]
