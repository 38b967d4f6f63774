"""The port's Threefry-2x32 against ``jax.random``, bit for bit (MLT's
``split`` and ``uniform`` among them): part 2 of the cases of
test_torch_threefry.py, in files of at most three test functions so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_threefry.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt_torch.sampling import threefry as tf
from test_torch_threefry import (  # noqa: F401  (fixtures among them)
    COUNTERS,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("seed,d", [(0, 0), (0, 5), (0, 46), (3, 11),
                                    (0x9E3779B9, 2)])
def test_fold_in_and_bits_equal_jax_over_counters(seed, d):
    jkey = jax.random.fold_in(jax.random.key(seed), d)
    key = tf.fold_in(tf.key(seed), d)
    want_k = np.asarray(jax.random.key_data(jkey))
    assert key == (int(want_k[0]), int(want_k[1]))
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jkey, jnp.asarray(COUNTERS))
    want0 = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (), jnp.uint32))(jkeys))
    want2 = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (2,), jnp.uint32))(jkeys))
    c = torch.as_tensor(COUNTERS.astype(np.int64))
    keys = tf.fold_in(key, c)
    np.testing.assert_array_equal(
        torch.stack(keys, -1).numpy().astype(np.uint32),
        np.asarray(jax.random.key_data(jkeys)))
    np.testing.assert_array_equal(tf.bits(keys).numpy().astype(np.uint32),
                                  want0)
    np.testing.assert_array_equal(tf.bits(keys, 1).numpy().astype(np.uint32),
                                  want2[:, 1])
    np.testing.assert_array_equal(want2[:, 0], want0)


def test_python_int_and_tensor_paths_agree():
    key = tf.fold_in(tf.key(11), 3)
    c = torch.as_tensor(COUNTERS[:50].astype(np.int64))
    got = tf.bits(tf.fold_in(key, c)).tolist()
    assert got == [tf.bits(tf.fold_in(key, int(x))) for x in COUNTERS[:50]]


def test_split_and_uniform_equal_jax():
    """MLT's bootstrap draws (tpurt's mlt.py:164-170): under three seeds a
    chain of ``split`` keys and ``uniform`` matrices under each, bit for
    bit, and a five-way split."""
    for seed in (0, 7, 0x9E3779B9):
        _split_and_uniform(seed)


def _split_and_uniform(seed):
    jkey, key = jax.random.key(seed), tf.key(seed)
    for shape in [(5,), (257, 13), (64, 62)]:
        jkey, jk = jax.random.split(jkey)
        key, k = tf.split(key)
        assert k == tuple(int(x) for x in np.asarray(jax.random.key_data(jk)))
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
        got = tf.uniform(k, shape).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    jkeys = jax.random.split(jkey, 5)
    assert tf.split(key, 5) == [
        tuple(int(x) for x in np.asarray(jax.random.key_data(q)))
        for q in jkeys]
