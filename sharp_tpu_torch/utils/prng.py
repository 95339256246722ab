"""Seed discipline: one integer `rN_seed` -> `torch.Generator` streams.

Counterpart of `sharp_tpu/utils/prng.py`. The reference pins every
stochastic stage from one seed `rN.seed` (RP sampling R/ranM.R:20-24,
per-member seeds `50 + rN.seed + k` R/SHARP.R:360, cell reshuffle
R/SHARP.R:497). Here each role gets its own generator, seeded from
(rN_seed, role, index) through numpy's SeedSequence:

    member_generator(seed, k)   # RP member k
    shuffle_generator(seed)     # cell permutation
    testlog_generator(seed)     # log-decision probe subset
    view_generator(seed)        # the shared 50-dim view projection of sharp_unlimited

A generator lives on the device it draws for: a CUDA generator gives other
numbers than a CPU one from the same seed, and neither reproduces the JAX
package's threefry streams. Tests that compare the two packages therefore
make the random arrays once and inject them (`sharp_tpu_torch.carry`).
"""

from __future__ import annotations

import secrets
from typing import Optional

import numpy as np
import torch

_MEMBER, _SHUFFLE, _TESTLOG = 1000, 1, 2
_VIEW = 0x56494557  # "VIEW", the JAX package's fold_in tag of the same role


def resolve_seed(rN_seed: Optional[int]) -> int:
    """`None` is the reference's 0.5 "not reproducible" sentinel
    (R/SHARP.R:169-179): a fresh random seed per call."""
    if rN_seed is None:
        return secrets.randbits(31)
    return int(rN_seed)


def _generator(words, device) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed & ((1 << 63) - 1))
    return gen


def member_generator(rN_seed: int, k: int, device) -> torch.Generator:
    """Stream for ensemble member k (the reference's `50 + rN.seed + k`)."""
    return _generator((rN_seed, _MEMBER, k), device)


def shuffle_generator(rN_seed: int, device) -> torch.Generator:
    return _generator((rN_seed, _SHUFFLE), device)


def testlog_generator(rN_seed: int, device) -> torch.Generator:
    return _generator((rN_seed, _TESTLOG), device)


def view_generator(rN_seed: int, device) -> torch.Generator:
    """Stream of the forview matrix: the one ternary RP that projects
    every block's viE to 50 view dimensions above 1e5 cells
    (R/SHARP_unlimited.R:216-235)."""
    return _generator((rN_seed, _VIEW), device)


def fixed_generator(seed: int, device) -> torch.Generator:
    """A plain `manual_seed(seed)` stream (the reference pins seed 5 for
    the testlog probe RP, R/SHARP.R:889)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
