"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and its entry points refuse to fall back
to the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax_or_repro():
    mods = _port_modules()
    for mod in ("repro_torch.core.capture", "repro_torch.models.model",
                "repro_torch.serving.engine", "repro_torch.launch.serve",
                "repro_torch.kernels.rmsnorm.ops",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.decode_attention.ops",
                "repro_torch.kernels.paged_decode.ops",
                "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                "repro_torch.optim.compression", "repro_torch.data.pipeline",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.runtime.fault_tolerance",
                "repro_torch.models.losses", "repro_torch.launch.steps",
                "repro_torch.launch.train", "repro_torch.utils.tree",
                "repro_torch.flags", "repro_torch.launch.analytic_cost",
                "repro_torch.launch.roofline", "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun",
                "repro_torch.launch.hlo_analysis", "repro_torch.parallel",
                "repro_torch.parallel.sharding",
                "repro_torch.parallel.collectives",
                "repro_torch.parallel.pipeline",
                "repro_torch.utils.sharding_ctx"):
        assert mod in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_module_tree_mirrors_the_reference():
    """Every module of the JAX package has its port, except
    ``parallel/compat.py`` (a shim over jax's ``shard_map`` API: a torch
    rank already runs per-device code); the port's own extras are the
    bridge, the kernel build, the span tracer (``trace.py``: timing events
    around the CUDA graph replay, which the reference, replaying no graph,
    has no counterpart of), the Mamba scan kernel's package
    (``kernels/mamba_scan``: the reference leaves the scan to XLA) and
    package ``__init__``s."""
    def tree(pkg):
        return {str(p.relative_to(pkg)) for p in pkg.rglob("*.py")}
    ref, port = tree(ROOT / "src" / "repro"), tree(PORT)
    assert ref - port == {"parallel/compat.py"}
    assert port - ref == {"__init__.py", "bridge.py", "kernels/_build.py",
                          "launch/__init__.py", "trace.py",
                          *(f"kernels/mamba_scan/{name}.py" for name in (
                              "__init__", "kernel", "ops", "ref"))}


def test_chaos_script_loads_no_jax_or_repro():
    """``scripts/torch_chaos_smoke.py`` runs on the card's machine, which has
    no JAX: importing it loads neither JAX nor the JAX package."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location("
            f"'chaos', {str(ROOT / 'scripts' / 'torch_chaos_smoke.py')!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "sys.modules['chaos'] = mod\n"
            "spec.loader.exec_module(mod)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  ROOT / "scripts" / "torch_chaos_smoke.py",
                                  *sorted(PORT.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), (
            f"{path.name} imports {name}")


def _entry_points():
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core import Session
    from repro_torch.models.transformer import init_lm
    import numpy as np
    from repro_torch.launch import serve, train
    from repro_torch.models import Model
    cfg = get_config("qwen2-0.5b", smoke=True)
    return {
        "init_lm": lambda: init_lm(cfg, torch.Generator().manual_seed(0)),
        "Session": lambda: Session(),
        "bridge": lambda: bridge.from_numpy({"w": np.zeros(2, np.float32)}),
        "Model.init": lambda: Model(cfg).init(torch.Generator().manual_seed(0)),
        "Model.init encdec": lambda: Model(
            get_config("whisper-medium", smoke=True)).init(
                torch.Generator().manual_seed(0)),
        "serve": lambda: serve.main(["--requests", "1"]),
        "train": lambda: train.main(["--steps", "1"]),
    }


@pytest.mark.parametrize("entry", ["init_lm", "Session", "bridge",
                                   "Model.init", "Model.init encdec",
                                   "serve", "train"])
def test_entry_points_raise_without_a_card_unless_asked_for_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry point runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[entry]()


def test_cpu_session_needs_an_explicit_hardware_spec():
    from repro_torch.core import Session, V5E
    with pytest.raises(ValueError, match="hw"):
        Session(device="cpu")
    assert Session(device="cpu", hw=V5E).config.hw is V5E


def test_chip_smoke_alone_exits_nonzero_without_a_result(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo:
    the script must fail and print no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
