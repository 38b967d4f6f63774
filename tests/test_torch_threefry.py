"""The port's Threefry-2x32 against ``jax.random``, bit for bit.

Tolerance: none.  Keys, fold_in and bits are integer functions; every
value must equal JAX's (under ``jax_threefry_partitionable=True``, which
the module's docstring names as the scheme it reproduces).  Inputs come
from a numpy seed and include counters at and around the uint32 edges.
"""

import jax
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
