"""The port's Threefry-2x32 against ``jax.random``, bit for bit: part 2 of the
cases of test_torch_threefry.py, in files of at most three cases so that
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
