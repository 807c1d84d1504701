"""A whole run of the harness on the CPU at smoke sizes, past its look for
a card: an unbroken program comes out correct, and each fault a cell can
have, planted in the timed path underneath the run, comes out not
correct."""
import itertools
import json
import types

import pytest
import torch

from portbench import harness

LIMITS = harness.read_json(harness.HERE / "workloads"
                           / "hymba-1.5b.b1s512.json")["limits"]


def _cell(cfg, batch=2, seq=16):
    traffic = {"loop": "closed", "clients": 1, "batch": batch, "seq": seq,
               "pool": 16, "sample": 3, "sample_from": 4, "warmup": 1,
               "trace_seconds": 0.05,
               "warmup_seconds": 0.1}
    m = harness.manifest()
    return harness.Cell("smoke", cfg, traffic, dict(LIMITS),
                        m["end_to_end"], m["per_layer"])


@pytest.fixture(autouse=True)
def _stepped_clock(monkeypatch):
    """The harness reads a clock that moves 20 ms a reading, so its
    warm-up and its window end after a fixed number of forwards (9 in
    the window, past its sample of the first 4), however slow the CPU
    that other test workers share."""
    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: 0.02 * next(ticks)))


def _run(cfg, wrap=None, trace=False):
    return harness.run_cell(_cell(cfg), seed=2 ** 31 + 11, seconds=0.5,
                            trace=trace, device="cpu", wrap=wrap)


def test_unbroken_run_is_correct(smoke_cfg):
    result = _run(smoke_cfg, trace=True)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    json.dumps(result)


class _Stale:
    """Answers every request with the logits of the one before it: a step
    that returns its state unchanged."""

    def __init__(self, model):
        self.model, self.last = model, None

    def __call__(self, inputs):
        outs = self.model(inputs)
        prev, self.last = self.last, outs
        return prev if prev is not None else outs


def _half_batch(model):
    """The second half of the batch left out: its rows repeat the first
    half's."""
    def call(inputs):
        ids = inputs["tokens"]
        half = ids.shape[0] // 2
        outs = model({"tokens": torch.cat([ids[:half], ids[:half]])})
        return outs
    return call


def _altered_token(model):
    """One token of each prompt altered where it is produced."""
    def call(inputs):
        ids = inputs["tokens"].clone()
        ids[:, ids.shape[1] // 2] = (ids[:, ids.shape[1] // 2] + 1) % 256
        return model({"tokens": ids})
    return call


def _altered_answer(model):
    """One position of each answer altered where it is produced."""
    def call(inputs):
        outs = model(inputs)
        logits = outs[-1].clone()
        logits[:, -1] = logits[:, -1].roll(1, dims=-1)
        return outs[:-1] + [logits]
    return call


@pytest.mark.parametrize("fault", [_Stale, _half_batch, _altered_token,
                                   _altered_answer])
def test_faults_come_out_not_correct(smoke_cfg, fault):
    result = _run(smoke_cfg, wrap=fault)
    assert result["correct"] is False, (fault, result["checks"])
