"""The benchmark's generators: rows, queries, scalar fields and calls, all
from the run's seed. Copied from the repository's older scripts (each file
names its original), not imported from them.

A configuration names its generators: `"vectors": "<name>"` for the rows
and queries (`<name>.py` with `vectors(n, dim, seed, stream, device)`), and
each field's `"generator"` (`<name>.py` with `fields(n, seed)`), so that a
configuration with other data adds a file here and edits none.
"""

import importlib

import numpy as np


def substream(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of draws of the run `seed` (any whole
    number >= 0, also above 2**31)."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0])


# the streams of one run, apart from each other
ROWS, QUERIES, FIELDS = 0, 1, 2


def generator(name: str):
    """The generator module `gen/<name>.py` that a configuration names."""
    return importlib.import_module(f"{__name__}.{name}")
