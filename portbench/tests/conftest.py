"""Shared pieces of the benchmark's CPU tests: the checkout on the path
and two smoke-sized configurations, one of each family, in the
benchmark's own configuration format."""
import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE = {
    "dense": {
        "name": "glm4-9b-smoke", "source": "smoke", "family": "dense",
        "dtype": "bfloat16", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "d_head": 16, "d_ff": 160, "vocab_size": 256,
        "qkv_bias": True, "tie_embeddings": False, "norm": "rmsnorm",
        "norm_eps": 1e-6, "window": None, "global_layers": [],
        "meta_tokens": 0, "ssm": None, "reduced": []},
    "hybrid": {
        "name": "hymba-1.5b-smoke", "source": "smoke", "family": "hybrid",
        "dtype": "bfloat16", "n_layers": 3, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "d_head": 16, "d_ff": 128, "vocab_size": 256,
        "qkv_bias": False, "tie_embeddings": True, "norm": "rmsnorm",
        "norm_eps": 1e-6, "window": 8, "global_layers": [0, 2],
        "meta_tokens": 4, "ssm": {"state_dim": 4, "conv_dim": 4,
                                  "expand": 2}, "reduced": []},
}


@pytest.fixture(params=sorted(SMOKE))
def smoke_cfg(request):
    return dict(SMOKE[request.param])


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "-m cuda portbench/tests)")


@pytest.fixture(autouse=True)
def _calibration_in_tmp(tmp_path, monkeypatch):
    """CPU runs keep the program's calibration tier out of the checkout."""
    from portbench import harness
    monkeypatch.setattr(harness, "BUILD", tmp_path / "build")
