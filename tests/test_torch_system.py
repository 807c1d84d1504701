"""The slice as a whole: the port's ``Session`` on a qwen2 smoke export
(2 layers, batch 2, seq 8, params converted from the JAX init by
``repro_torch.bridge``) against the JAX package's captured program.

Tolerances: fp32 1e-5 (the same arithmetic; the two frameworks' CPU
kernels may sum in other orders, which 1e-5 absorbs at these sizes); bf16
2e-2, the JAX package's own bf16 differential tolerance (each GEMM rounds
its output to bf16, so results differ by bf16 ulps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.core.session import SessionConfig as RefSessionConfig  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig, SimConfig  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core.session import _content_digest  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S = 2, 8


def _configs(dtype):
    jnp_dt, torch_dt, _ = DTYPES[dtype]
    return (dataclasses.replace(ref_config("qwen2-0.5b", smoke=True),
                                dtype=jnp_dt),
            dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                                dtype=torch_dt))


def _params(rc, seed=0):
    params = make_model(rc).init(jax.random.key(seed))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_session_compile_matches_reference_captured_program(dtype, tmp_path):
    rc, pc = _configs(dtype)
    params, np_params = _params(rc)
    rg = ref_export(rc, batch=B, seq=S, params=params)
    pg = build_lm_opgraph(pc, batch=B, seq=S,
                          params=bridge.from_numpy(np_params, "cpu"))
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"), gemm_kernel="pallas")
    sess = Session(SessionConfig(device="cpu", hw=V5E, autotune=True,
                                 sim_cfg=SimConfig(head_of_line=True),
                                 calib_dir=str(tmp_path)))
    tol = DTYPES[dtype][2]
    model = sess.compile(pg, inputs={0: torch.from_numpy(
        _tokens(rc.vocab_size, 0)).long()})
    assert model.executable.program_stats()["n_branch_gemm"] == 4
    for seed in (1, 2, 3):
        tok = _tokens(rc.vocab_size, seed)
        want = rexe({"tokens": jnp.asarray(tok)})
        got = model({"tokens": torch.from_numpy(tok)})
        assert len(got) == len(want) == 1
        assert tuple(got[0].shape) == (B, S, rc.vocab_size)
        assert got[0].dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(got[0].float().numpy(),
                                   np.asarray(want[0], np.float32),
                                   rtol=tol, atol=tol)
        seq = run_sequential_uncompiled(pg, {"tokens": torch.from_numpy(tok)},
                                        model.executable.output_ids)
        torch.testing.assert_close(got[0].float(), seq[0].float(),
                                   rtol=tol, atol=tol)


def _provenance_run(make_session, export, to_tokens, calib_dir):
    """One fixed sequence of Session calls; returns what each build hit."""
    out = []
    s1 = make_session(calib_dir, "identity")
    g, g_reloaded = export(), export()
    inputs = {0: to_tokens()}
    out.append(s1.compile(g, inputs=inputs).provenance)
    out.append(s1.compile(g, inputs=inputs).provenance)
    out.append(s1.compile(g_reloaded, inputs=inputs).provenance)
    out.append(dict(s1.cache_stats()))
    s2 = make_session(calib_dir, "content")
    out.append(s2.compile(g, inputs=inputs).provenance)
    out.append(s2.compile(g_reloaded, inputs=inputs).provenance)
    out.append(s2.compile(g).provenance)
    out.append(dict(s2.cache_stats()))
    return out


def test_session_cache_provenance_matches_reference(tmp_path):
    rc, pc = _configs("bfloat16")
    params, np_params = _params(rc)
    tok = _tokens(rc.vocab_size, 0)

    ref = _provenance_run(
        lambda d, wk: RefSession(RefSessionConfig(autotune=True, calib_dir=d,
                                                  weights_key=wk)),
        lambda: ref_export(rc, batch=B, seq=S, params=jax.tree_util.tree_map(
            jnp.asarray, np_params)),
        lambda: jnp.asarray(tok), str(tmp_path / "ref"))
    port = _provenance_run(
        lambda d, wk: Session(SessionConfig(device="cpu", hw=V5E,
                                            autotune=True, calib_dir=d,
                                            weights_key=wk)),
        lambda: build_lm_opgraph(pc, batch=B, seq=S,
                                 params=bridge.from_numpy(np_params, "cpu")),
        lambda: torch.from_numpy(tok), str(tmp_path / "port"))
    assert port == ref
    assert [p["calibration"] for p in port if "calibration" in p] == [
        "measured", "memory", "memory", "disk", "memory", "off"]


def test_bf16_bridge_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((64, 33)) * 10).astype(ml_dtypes.bfloat16)
    a[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    t = bridge.array_to_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    back = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    assert back.tobytes() == a.tobytes()
    params = jax.tree_util.tree_map(
        np.asarray, make_model(ref_config("qwen2-0.5b", smoke=True)).init(
            jax.random.key(1)))
    tree = bridge.from_numpy(params, "cpu")
    w = params["stacks"][0]["attn"]["wq"]["w"]
    tw = tree["stacks"][0]["attn"]["wq"]["w"]
    assert tw.view(torch.int16).numpy().tobytes() == w.view(np.int16).tobytes()


def test_content_digest_hashes_bf16_bits():
    a = torch.randn(4, 4).to(torch.bfloat16)
    assert _content_digest(a) == _content_digest(a.clone())
    b = a.clone()
    b[0, 0] = b[0, 0] + 1
    assert _content_digest(a) != _content_digest(b)
