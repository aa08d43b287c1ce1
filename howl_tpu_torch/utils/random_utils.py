"""Seeding helpers.

The numeric core draws from explicit ``torch.Generator``s; this module only seeds the
host-side RNGs used by dataset sampling and ETL (ref: howl/utils/random_utils.py).
"""

from __future__ import annotations

import random

import numpy as np


def set_random_seed(seed: int = 0):
    random.seed(seed)
    np.random.seed(seed)
    return seed
