"""The port's threefry streams against `jax.random`, bit for bit.

Both sides draw through their package's `SimRNG` / `Stream` (the JAX side
under the x64 settings the JAX CLI runs with): key data after
``PRNGKey`` / ``fold_in``; `uniform` at float64 (and float32, the Poisson
samplers' draw) and `uniform_int` equal bit for bit; `poisson_int` counts
equal over 500 counters at each rate, across Knuth (< 10) and Hormann's
rejection (>= 10); `normal` equal to within 1 ulp (it has been exact); and
`dump_state` / `from_state` round trips that continue the JAX stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skellysim_tpu.utils.rng import SimRNG as JRNG
from skellysim_tpu.utils.rng import Stream as JStream
from skellysim_tpu_torch.utils import rng as trng

SEEDS = (0, 1, 2 ** 31, 2 ** 32 + 5)
SIZES = (None, 1, 7, 1000, 4096)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream_id", range(10))
def test_key_data(seed, stream_id):
    for counter in (0, 1, 1000):
        js = JStream(seed, stream_id, counter)
        ts = trng.Stream(seed, stream_id, counter)
        np.testing.assert_array_equal(
            ts._next_key(), np.asarray(jax.random.key_data(js._next_key())))
        assert ts.counter == js.counter == counter + 1


@pytest.mark.parametrize("size", SIZES)
def test_uniform_f64(size):
    js, ts = JStream(7, 1, 3), trng.Stream(7, 1, 3)
    for _ in range(2):
        a, b = js.uniform(size=size), ts.uniform(size=size)
        if size is None:
            assert isinstance(b, float) and a == b
        else:
            np.testing.assert_array_equal(b, a)
    assert js.dump() == ts.dump()


@pytest.mark.parametrize("size", SIZES)
def test_uniform_f32(size):
    js, ts = JStream(11, 0, 5), trng.Stream(11, 0, 5)
    shape = () if size is None else (size,)
    a = np.asarray(jax.random.uniform(js._next_key(), shape, jnp.float32))
    b = trng.uniform(ts._next_key(), int(np.prod(shape)), np.float32)
    np.testing.assert_array_equal(b.reshape(shape), a)


@pytest.mark.parametrize("high", (1, 12, 1000, 2 ** 31 - 1))
@pytest.mark.parametrize("size", (None, 7, 1000))
def test_uniform_int(high, size):
    js, ts = JStream(2 ** 32 + 5, 1), trng.Stream(2 ** 32 + 5, 1)
    for _ in range(3):
        a, b = js.uniform_int(0, high, size=size), ts.uniform_int(0, high,
                                                                 size=size)
        if size is None:
            assert isinstance(b, int) and a == b
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("lam", (0.0, 0.1, 3.0, 9.99, 10.0, 30.0, 200.0,
                                 8000.0))
def test_poisson_counts(lam):
    """500 consecutive counters of one stream: the counts are equal, draw
    for draw (not only in law)."""
    js, ts = JStream(5, 1), trng.Stream(5, 1)
    a = [js.poisson_int(lam) for _ in range(500)]
    b = [ts.poisson_int(lam) for _ in range(500)]
    assert a == b
    assert js.dump() == ts.dump()
    if lam:
        assert abs(np.mean(b) / lam - 1) < 0.5


def test_poisson_sized_draw_spends_one_counter():
    js, ts = JStream(9, 1), trng.Stream(9, 1)
    np.testing.assert_array_equal(ts.poisson_int(200.0, size=64),
                                  js.poisson_int(200.0, size=64))
    assert ts.counter == js.counter == 1


@pytest.mark.parametrize("size", (None, 1, 7, 1000))
def test_normal_within_one_ulp(size):
    js, ts = JStream(3, 0, 2), trng.Stream(3, 0, 2)
    a = np.asarray(js.normal(size=size))
    b = np.asarray(ts.normal(size=size))
    ulp = np.spacing(np.abs(a))
    assert np.all(np.abs(a - b) <= ulp)


def _draws(stream):
    return [stream.uniform(), stream.poisson_int(3.0), stream.poisson_int(40.0),
            stream.uniform_int(0, 100), stream.uniform(size=5).tolist()]


@pytest.mark.parametrize("warmup", (0, 1, 17))
def test_dump_state_continues_the_jax_stream(warmup):
    """A port stream restored from a state the JAX package dumped (and
    vice versa) continues the JAX stream."""
    j = JRNG(42)
    for _ in range(warmup):
        j.distributed.uniform(size=3)
        j.shared.uniform()
    state = j.dump_state()
    t = trng.SimRNG.from_state(state)
    assert t.dump_state() == state
    assert _draws(t.distributed) == _draws(j.distributed)
    assert _draws(t.shared) == _draws(j.shared)
    back = JRNG.from_state(t.dump_state())
    assert _draws(back.distributed) == _draws(t.distributed)
