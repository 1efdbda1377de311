"""Seeds (PyTorch port of `happypose_tpu/utils/random.py`): a hash of
structured data (host, epoch, step, ...) gives a 31-bit seed; where JAX
folds it into a PRNG key, the port seeds a `torch.Generator` on the device
the draws are made on. A CUDA generator gives other numbers than a CPU one
for the same seed, and both differ from `jax.random`."""

from __future__ import annotations

import contextlib
import hashlib
from typing import Iterator

import numpy as np
import torch


def make_seed(*args) -> int:
    """Deterministic 31-bit seed from arbitrary hashable args."""
    h = hashlib.sha256("/".join(str(a) for a in args).encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def generator_for(*args, device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded from structured data."""
    return torch.Generator(device=device).manual_seed(make_seed(*args))


@contextlib.contextmanager
def temp_numpy_seed(seed: int) -> Iterator[None]:
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
