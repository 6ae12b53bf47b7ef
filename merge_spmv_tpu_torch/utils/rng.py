"""Random generation harness utilities.

Parity with the reference harness RNG (utils.h:74-269): a Mersenne Twister
generator (`mersenne::genrand_int32`, utils.h:74-188 — NumPy's RandomState
is the same MT19937 core), `RandomBits`-style entropy-reduced integer keys
(utils.h:213-255: AND-ing k draws biases bits toward 0, the reference's way
of generating skewed key distributions), and uniform `RandomValue` fills
(utils.h:259-269).  These host helpers exist for dataset/fixture
generation parity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mersenne", "random_bits", "random_values"]


def mersenne(seed: int = 0) -> np.random.RandomState:
    """MT19937 generator (the reference's mersenne::init_genrand analog)."""
    return np.random.RandomState(seed)


def random_bits(shape, entropy_reduction: int = 0, begin_bit: int = 0,
                end_bit: int = 32, seed: int = 0, rs=None) -> np.ndarray:
    """Entropy-controlled random uint32 keys (utils.h:213-255).

    entropy_reduction > 0 ANDs that many extra draws together (bits biased
    toward 0 — sparser/skewed keys); -1 yields all-ones.  Bits outside
    [begin_bit, end_bit) are cleared.
    """
    rs = rs or mersenne(seed)
    if entropy_reduction < 0:
        out = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    else:
        out = rs.randint(0, 1 << 32, size=shape, dtype=np.uint32)
        for _ in range(entropy_reduction):
            out &= rs.randint(0, 1 << 32, size=shape, dtype=np.uint32)
    mask = np.uint32(0)
    for b in range(begin_bit, min(end_bit, 32)):
        mask |= np.uint32(1) << np.uint32(b)
    return out & mask


def random_values(shape, dtype=np.float64, lo: float = 0.0, hi: float = 1.0,
                  seed: int = 0, rs=None) -> np.ndarray:
    """Uniform random fill (utils.h:259-269 semantics: value in [lo, hi))."""
    rs = rs or mersenne(seed)
    return rs.uniform(lo, hi, size=shape).astype(dtype)
