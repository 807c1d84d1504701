"""The benchmark finds what it runs by name, and loads neither JAX nor
the JAX package: each module's imports are read, and its top-level name
(the part before the first dot) compared whole."""
import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _modules():
    return sorted(p for p in ROOT.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    # "repro_torch" begins with "repro" but is another name
    assert "repro" not in _imports(path) and "jax" not in _imports(path)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "torch",
                              "portbench"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_manifest_names_files_that_exist():
    m = harness.manifest()
    for c in m["configs"]:
        cfg = json.loads((ROOT.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (ROOT / "reference" / f"{cfg['family']}.py").exists()
        assert (ROOT / "families" / f"{cfg['family']}.py").exists()
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.cfg["name"] == w["config"]
        assert set(cell.limits) == {"row_rel_l2", "pos_rel_l2"}
        assert [x["name"] for x in cell.end_to_end] == [
            "forward_ms", "forward_p95_ms", "peak_mem_gib", "setup_s"]
    for x in m["per_layer"]:
        assert callable(harness.metric_reader(x["name"]))


def test_a_cell_dropped_into_a_copy_is_found(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    m = harness.manifest()
    m["workloads"].append({"name": "glm4-9b.b2s64", "config": "glm4-9b",
                           "traffic": "b2s64", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    traffic = json.loads((copy / "traffic" / "b1s32.json").read_text())
    traffic.update(batch=2, seq=64)
    (copy / "traffic" / "b2s64.json").write_text(json.dumps(traffic))
    (copy / "workloads" / "glm4-9b.b2s64.json").write_text(json.dumps(
        {"config": "glm4-9b", "traffic": "b2s64", "why": "test",
         "limits": {"row_rel_l2": 0.1, "pos_rel_l2": 0.1}}))
    cell = harness.load_cell("glm4-9b.b2s64", root=copy)
    assert (cell.traffic["batch"], cell.traffic["seq"]) == (2, 64)
    assert cell.cfg["d_model"] == 4096
    with pytest.raises(KeyError):
        harness.load_cell("glm4-9b.b2s64")     # not in the real tree


def test_refuses_without_a_card_or_without_the_port(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("the refusal without a card is checked on a CPU host")
    run = [sys.executable, "portbench/run.py", "--workload",
           "glm4-9b.b1s512", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    done = subprocess.run(run, cwd=ROOT.parent, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copytree(ROOT, tmp_path / "portbench")
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    done = subprocess.run(run, cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == ""
