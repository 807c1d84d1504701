"""The port's synthetic token pipeline against the JAX package's: the same
(seed, step, host split) gives bit-equal batches, and the reference's
``tests/test_data.py`` cases hold on the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import make_dataset as ref_make_dataset  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_batch_at_is_bit_equal_to_the_reference(seed, n_hosts):
    for host_id in range(n_hosts):
        ref = ref_make_dataset(151936, 24, 8, seed=seed, n_hosts=n_hosts,
                               host_id=host_id)
        port = make_dataset(151936, 24, 8, seed=seed, n_hosts=n_hosts,
                            host_id=host_id)
        for step in (0, 1, 17, 1000):
            want, got = ref.batch_at(step), port.batch_at(step)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


def test_iteration_and_repartition_follow_the_reference():
    ref, port = ref_make_dataset(1000, 16, 8), make_dataset(1000, 16, 8)
    ref_it, port_it = iter(ref), iter(port)
    for _ in range(3):
        np.testing.assert_array_equal(next(port_it)["tokens"],
                                      next(ref_it)["tokens"])
    assert port.state_dict() == ref.state_dict()
    r2, p2 = ref.repartition(4, 3), port.repartition(4, 3)
    np.testing.assert_array_equal(p2.batch_at(p2.step)["labels"],
                                  r2.batch_at(r2.step)["labels"])


# -- the reference's tests/test_data.py cases, on the port ---------------------------

def test_deterministic_given_seed():
    d1 = make_dataset(1000, 32, 8, seed=7)
    d2 = make_dataset(1000, 32, 8, seed=7)
    b1, b2 = d1.batch_at(5), d2.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_labels_are_shifted_tokens():
    d = make_dataset(1000, 32, 4)
    b = d.batch_at(0)
    assert b["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_hosts_read_disjoint_shards():
    full = make_dataset(1000, 16, 8, n_hosts=1, host_id=0).batch_at(3)
    h0 = make_dataset(1000, 16, 8, n_hosts=2, host_id=0).batch_at(3)
    h1 = make_dataset(1000, 16, 8, n_hosts=2, host_id=1).batch_at(3)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), full["tokens"])


def test_repartition_preserves_stream():
    d = make_dataset(1000, 16, 8, n_hosts=2, host_id=0)
    for _ in range(4):
        next(iter(d))
    d2 = d.repartition(n_hosts=4, host_id=1)
    assert d2.step == d.step
    # global content at a step is identical regardless of partitioning
    full = make_dataset(1000, 16, 8).batch_at(d.step)["tokens"]
    part = d2.batch_at(d2.step)["tokens"]
    np.testing.assert_array_equal(part, full[2:4])


def test_state_dict_roundtrip():
    d = make_dataset(1000, 16, 4)
    it = iter(d)
    next(it); next(it); next(it)
    state = d.state_dict()
    d2 = make_dataset(1000, 16, 4)
    d2.load_state_dict(state)
    np.testing.assert_array_equal(d.batch_at(d.step)["tokens"],
                                  d2.batch_at(d2.step)["tokens"])
