"""The port's Threefry-2x32 against ``jax.random``, bit for bit.

Tolerance: none.  Keys, fold_in and bits are integer functions; every
value must equal JAX's (under ``jax_threefry_partitionable=True``, which
the module's docstring names as the scheme it reproduces).  Inputs come
from a numpy seed and include counters at and around the uint32 edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt_torch.sampling import threefry as tf

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

RNG = np.random.default_rng(20)
COUNTERS = np.concatenate([
    np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
             np.uint32),
    RNG.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)])


def test_partitionable_flag_is_the_one_reproduced():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 0x5157, 0x9E3779B9, 0xFFFFFFFF])
def test_key_words(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert tf.key(seed) == (int(want[0]), int(want[1]))


def test_known_values_of_one_chain():
    k = tf.fold_in(tf.key(0), 7)
    assert k == (2716826189, 292468403)
    k = tf.fold_in(k, 5)
    assert tf.bits(k) == 3980310627 and tf.bits(k, 1) == 4085472933


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
