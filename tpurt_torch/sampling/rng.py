"""PCG32 random number generator, vectorized over numpy uint64 lanes.

Bit-exact with the reference's PCG32 (core/rng.h:61-144): same default
state/stream, SetSequence, advance, bounded-uint rejection sampling and
float mapping.  Used host-side to generate the Halton scrambling
permutations (lowdiscrepancy.cpp:2490) and for bit-parity tests of the
"random" sampler; the device-side default RNG is counter-based threefry
(jax.random), which needs no state at all.
"""

from __future__ import annotations

import numpy as np

_MULT = np.uint64(0x5851F42D4C957F2D)
_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
_DEFAULT_STREAM = np.uint64(0xDA3E39CB94B95BDB)
_ONE_MINUS_EPS = np.float32(1.0) - np.float32(2.0 ** -24)

def _err():
    # numpy warns on uint64 overflow; PCG32 relies on mod-2^64 wrap-around,
    # which numpy's uint64 arithmetic provides.
    return np.errstate(over="ignore")


class PCG32:
    """Vectorized PCG32. ``seq`` may be a scalar or an array of sequence
    indices; all lanes advance in lockstep."""

    def __init__(self, seq=None):
        if seq is None:
            self.state = np.array(_DEFAULT_STATE, dtype=np.uint64)
            self.inc = np.array(_DEFAULT_STREAM, dtype=np.uint64)
        else:
            self.set_sequence(np.asarray(seq, dtype=np.uint64))

    def set_sequence(self, initseq: np.ndarray) -> None:
        with _err():
            self.state = np.zeros_like(initseq, dtype=np.uint64)
            self.inc = (initseq << np.uint64(1)) | np.uint64(1)
            self.uniform_uint32()
            self.state = self.state + _DEFAULT_STATE
            self.uniform_uint32()

    def uniform_uint32(self) -> np.ndarray:
        with _err():
            old = self.state
            self.state = old * _MULT + self.inc
            xorshifted = (((old >> np.uint64(18)) ^ old) >> np.uint64(27)).astype(
                np.uint32
            )
            rot = (old >> np.uint64(59)).astype(np.uint32)
            return (xorshifted >> rot) | (
                xorshifted << ((~rot + np.uint32(1)) & np.uint32(31))
            )

    def uniform_uint32_bounded(self, b: int) -> np.ndarray:
        """Rejection-sampled bounded uniform, identical consumption order to
        rng.h:71-77 per-lane (lanes that accept early still step in lockstep
        is NOT what the scalar reference does, so this is scalar-safe only
        for scalar use; the permutation generator below calls it on
        scalars)."""
        b32 = np.uint32(b)
        threshold = (~b32 + np.uint32(1)) % b32
        while True:
            r = self.uniform_uint32()
            if np.ndim(r) == 0:
                if r >= threshold:
                    return r % b32
            else:  # vector lanes: loop until all accepted (rare)
                ok = r >= threshold
                if ok.all():
                    return r % b32
                # Scalar reference redraws only rejecting lanes; emulate.
                out = r % b32
                bad = ~ok
                sub = PCG32.__new__(PCG32)
                sub.state = self.state[bad]
                sub.inc = self.inc if np.ndim(self.inc) == 0 else self.inc[bad]
                out[bad] = sub.uniform_uint32_bounded(b)
                self.state[bad] = sub.state
                return out

    def uniform_float(self) -> np.ndarray:
        u = self.uniform_uint32()
        return np.minimum(
            _ONE_MINUS_EPS, (u * np.float32(2.3283064365386963e-10)).astype(np.float32)
        )


def shuffle_inplace(arr: np.ndarray, rng: PCG32) -> None:
    """Fisher-Yates with the reference's forward order (sampling.h:151-157):
    swap i with i + U(count - i)."""
    n = len(arr)
    for i in range(n):
        other = i + int(rng.uniform_uint32_bounded(n - i))
        arr[i], arr[other] = arr[other], arr[i]
