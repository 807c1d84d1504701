"""End-to-end serving run (continuous batching on a smoke model).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 8 --max-tokens 16 [--arch hymba-1.5b]

The JAX package's ``launch/serve.py`` with the same options, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
``--arch`` takes any registered architecture (its smoke config): qwen2-0.5b,
llama3.2-1b, minicpm-2b, glm4-9b, kimi-k2-1t-a32b (MoE), deepseek-v3-671b
(MLA), rwkv6-1.6b (recurrent state, dense slab) or hymba-1.5b (attention
beside a Mamba head, meta tokens, dense slab); the engine serves decoder
LMs only, so whisper-medium (encoder-decoder) is refused, as the JAX
package's engine has no path for it.
The model runs its kernel route (``use_kernels=True``).  Multi-tenant
overload mode: ``--tenants N`` spreads the requests over N tenants, each
with its own isolated :class:`repro_torch.core.Session`, and ``--overload``
arms the admission tier (bounded queue, per-tenant quotas, mixed priorities
and tick deadlines) against a burst trace, printing the goodput / shed /
expiry ledger.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import Session, V5E
from ..models import Model
from ..models.layers import check_device
from ..serving import (AdmissionConfig, InferenceEngine, Request,
                       RequestState, TERMINAL_STATES)


def _session(device: torch.device) -> Session:
    # a CPU session schedules for an explicit spec; on the card the spec is
    # the card's own
    return Session(device=device.type,
                   hw=V5E if device.type == "cpu" else None)


def serve(arch: str, n_requests: int, max_tokens: int, slots: int = 4,
          max_len: int = 128, temperature: float = 0.0,
          calibrate: bool = False, tenants: int = 1,
          overload: bool = False, max_queue: int | None = None,
          tenant_quota: int | None = None, ttl: int | None = None,
          device: str = "cuda") -> dict:
    dev = check_device(device)
    cfg = get_config(arch, smoke=True)
    if cfg.family == "encdec":
        raise ValueError(f"{arch} is an encoder-decoder model; the serving "
                         "engine serves decoder LMs")
    model = Model(cfg, use_kernels=True)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    # one Session for the serving process, and an isolated one per tenant
    # that collects that tenant's degradation provenance
    session = _session(dev)
    tenant_names = [f"tenant{i}" for i in range(max(1, tenants))]
    tenant_sessions = {name: _session(dev) for name in tenant_names}
    admission = AdmissionConfig(max_queue=max_queue,
                                tenant_quota=tenant_quota)
    engine = InferenceEngine(model, params, max_slots=slots, max_len=max_len,
                             session=session, calibrate=calibrate,
                             admission=admission,
                             tenant_sessions=tenant_sessions)
    if calibrate and engine.schedule_plan is not None:
        p = engine.schedule_plan
        stats = session.cache_stats()
        mode = ("analytic (degraded)" if stats["calib_degraded_analytic"]
                else "measured")
        print(f"[serve] opara schedule [{mode}]: streams={p.n_streams} "
              f"waves={p.waves.n_waves} (calibration "
              f"{stats['calib_misses']} timed / "
              f"{stats['calib_hits']} cached)")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(n_requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=rng.integers(4, 12)).tolist()
        req = Request(rid=rid, prompt=prompt, max_tokens=max_tokens,
                      temperature=temperature,
                      tenant=tenant_names[rid % len(tenant_names)])
        if overload:
            req.priority = rid % 3
            req.ttl = ttl if ttl is not None else max_tokens * 2 + 8
        engine.submit(req)
    done = engine.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    by_state = {s.value: 0 for s in TERMINAL_STATES}
    for r in done:
        by_state[r.state.value] += 1
    assert all(r.state in TERMINAL_STATES for r in done), \
        "engine returned a non-terminal request"
    total_tokens = sum(len(r.output) for r in done)
    result = {
        "device": str(dev),
        "completed": by_state["done"],
        "failed": by_state["failed"],
        "shed": by_state["shed"],
        "expired": by_state["expired"],
        "total_tokens": total_tokens,
        "wall_s": wall,
        "tok_per_s": total_tokens / wall if wall > 0 else 0.0,
    }
    for r in done[:8]:
        if r.state is RequestState.DONE:
            print(f"[serve] rid={r.rid} {r.tenant} prompt_len={len(r.prompt)} "
                  f"out={r.output[:8]}{'...' if len(r.output) > 8 else ''}")
        else:
            print(f"[serve] rid={r.rid} {r.tenant} {r.state.value.upper()}: "
                  f"{r.error}")
    if tenants > 1 or overload:
        for name in tenant_names:
            stats = engine.fault_stats["by_tenant"].get(name, {})
            events = len(tenant_sessions[name].guard_log)
            print(f"[serve] {name}: {stats} ({events} provenance events)")
        print(f"[serve] health: {engine.health()}")
    print(f"[serve] {result}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--calibrate", action="store_true",
                    help="measured-profile Opara schedule of the step graph")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests over N isolated tenants")
    ap.add_argument("--overload", action="store_true",
                    help="arm the admission tier: priorities + deadlines")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on the admission queue (shed beyond)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max queued requests per tenant")
    ap.add_argument("--ttl", type=int, default=None,
                    help="per-request deadline in ticks from submission")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    args = ap.parse_args(argv)
    res = serve(args.arch, args.requests, args.max_tokens, args.slots,
                calibrate=args.calibrate, tenants=args.tenants,
                overload=args.overload, max_queue=args.max_queue,
                tenant_quota=args.tenant_quota, ttl=args.ttl,
                device=args.device)
    terminal = (res["completed"] + res["failed"] + res["shed"]
                + res["expired"])
    ok = (terminal == args.requests
          and (res["completed"] == args.requests
               or args.overload or args.max_queue is not None))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
