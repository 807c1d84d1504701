"""The plain references against the port's op graph at smoke sizes on the
CPU: in float32 they compute the same function; in bfloat16 the program
stays within rounding of the float32 reference; the fp8 control does not
stay as close."""
import pytest
import torch

from portbench import harness
from portbench.harness import compare, make_weights


def _program_logits(cfg, weights, ids):
    graph, model = harness.compile_program(cfg, weights, ids.shape[0],
                                           ids.shape[1], ids, "cpu")
    return model({"tokens": ids})[-1]


@pytest.mark.parametrize("seq", [12, 20])
def test_reference_equals_port_in_fp32(smoke_cfg, seq):
    cfg = dict(smoke_cfg, dtype="float32")
    weights = make_weights(cfg, 1234, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (2, seq),
                        generator=torch.Generator().manual_seed(seq))
    got = _program_logits(cfg, weights, ids)
    assert got.shape == (2, seq, cfg["vocab_size"])
    checks = compare(cfg, weights, ids, got)
    assert checks["pos_rel_l2"] < 1e-5, checks


def test_bf16_program_within_rounding_and_fp8_control_outside(smoke_cfg):
    weights = make_weights(smoke_cfg, 99, "cpu")
    ids = torch.randint(0, smoke_cfg["vocab_size"], (2, 16),
                        generator=torch.Generator().manual_seed(3))
    got = _program_logits(smoke_cfg, weights, ids)
    program = compare(smoke_cfg, weights, ids, got)
    from portbench.reference.common import logits
    ref = harness.reference_module(smoke_cfg)
    control = torch.stack([logits(smoke_cfg, weights, h, "fp8") for h in
                           ref.hidden(smoke_cfg, weights, ids, "fp8")])
    against = compare(smoke_cfg, weights, ids, control)
    assert program["row_rel_l2"] < 0.05, program
    for k in program:
        assert against[k] > 3 * program[k], (k, program, against)


def test_window_masks_far_keys():
    from portbench.reference.common import attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 10, 2, 4, generator=g) for _ in range(3))
    full = attention(q, k, v, None, None)
    windowed = attention(q, k, v, 3, None)
    assert torch.allclose(full[:, :3], windowed[:, :3])
    assert not torch.allclose(full[:, 3:], windowed[:, 3:])
    # a windowed query sees only its last 3 keys: moving an older key
    # leaves it unchanged
    k2, v2 = k.clone(), v.clone()
    k2[:, 0], v2[:, 0] = 5.0, 5.0
    assert torch.allclose(attention(q, k2, v2, 3, None)[:, 3:],
                          windowed[:, 3:])
