"""Scalar fields `tag` and `price`: the generator a configuration's field
names by `"generator": "fields_arrays"`.

Copied from `benchmarks/bench_ivf10m.py:89-93` (a tag in 0..9, uniform, then
a price uniform in [0, 1), drawn in that order from one generator); there
its seed is a constant, here it is stream FIELDS of the run's seed.
`tag = 'tN'` keeps ~10% of rows, `price < p` a share p.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import FIELDS, substream


def fields(n: int, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(substream(seed, FIELDS))
    tags = rng.integers(0, 10, n)
    price = rng.random(n)
    return {"tag": tags, "price": price}
