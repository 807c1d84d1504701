"""``scripts/torch_chaos_smoke.py`` on the CPU at smoke size, so the script
cannot rot: every one of its 14 scenarios passes its contract check, the
scenarios are the JAX script's in the same order and arm every fault site,
``main --device cpu`` prints ``[chaos] 14/14 sites clean`` and exits 0
(on stub checks), a broken site makes it exit non-zero, and
``--device cuda`` raises without a card.
"""
import importlib.util
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime.faults import SITES  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


chaos = _load("torch_chaos_smoke", ROOT / "scripts" / "torch_chaos_smoke.py")


@pytest.fixture(scope="module")
def setup():
    s = chaos.Setup("cpu", "smoke", seed=0)
    yield s
    s.close()


@pytest.mark.parametrize("index", range(len(chaos.SCENARIOS)),
                         ids=[f"{i}-{spec}" for i, (spec, _, _)
                              in enumerate(chaos.SCENARIOS)])
def test_scenario_keeps_the_contract_on_the_cpu(setup, index):
    spec, check, _ = chaos.SCENARIOS[index]
    report = check(setup, spec)
    assert isinstance(report, str) and report


def test_scenarios_are_the_reference_scripts_and_arm_every_site():
    pytest.importorskip("jax")
    ref = _load("chaos_smoke_reference", ROOT / "scripts" / "chaos_smoke.py")
    specs = [spec for spec, _, _ in chaos.SCENARIOS]
    assert specs == [spec for spec, _ in ref.SCENARIOS]
    assert {spec.split(":")[0] for spec in specs} == set(SITES)
    assert chaos.ENGINE_SITES == ref._ENGINE_SITES


def _stub_scenarios(broken: int | None = None) -> list:
    """The script's scenarios with stub checks (the parametrised test above
    runs the real ones): each reports "stub", the one at ``broken`` raises."""
    def ok(setup, spec):
        return "stub"

    def raises(setup, spec):
        raise AssertionError("contract broken")

    return [(spec, raises if i == broken else ok, kernels)
            for i, (spec, _, kernels) in enumerate(chaos.SCENARIOS)]


def test_main_on_the_cpu_prints_every_site_clean(monkeypatch, capsys):
    monkeypatch.setattr(chaos, "SCENARIOS", _stub_scenarios())
    assert chaos.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ok = [ln for ln in lines if ln.startswith("[chaos] ") and " ok (" in ln]
    assert len(ok) == len(chaos.SCENARIOS) == 14
    assert lines[-1] == "[chaos] 14/14 sites clean"


def test_a_broken_site_fails_the_run(monkeypatch, capsys):
    """A scenario whose contract check fails is reported and makes the run
    exit non-zero; the others still run, and skipped sites are not counted
    as clean."""
    spec = chaos.SCENARIOS[6][0]
    assert not spec.startswith(chaos.ENGINE_SITES)
    monkeypatch.setattr(chaos, "SCENARIOS", _stub_scenarios(broken=6))
    assert chaos.main(["--device", "cpu", "--skip-engine"]) == 1
    out = capsys.readouterr().out
    assert f"[chaos] FAIL {spec}" in out and "contract broken" in out
    n_engine = sum(s.startswith(chaos.ENGINE_SITES)
                   for s, _, _ in chaos.SCENARIOS)
    assert n_engine == 7
    assert out.count("[chaos] SKIP ") == n_engine
    assert out.splitlines()[-1] == (
        f"[chaos] {14 - n_engine - 1}/14 sites clean ({n_engine} skipped)")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="--device cpu"):
        chaos.main([])
