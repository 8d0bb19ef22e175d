"""The scalar fields of a configuration's rows.

Each entry of the configuration's `fields` names its generator, a module
`gen/<generator>.py` with `fields(n, seed) -> {name: array}`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import generator


def make_fields(specs: list, n: int, seed: int) -> Dict[str, np.ndarray]:
    """The values of each field of a configuration's `fields` list, as the
    program stores them: a field's `format` turns integer codes into strings
    (`"t{}"`: 3 -> 't3'). Fields of one generator come from one draw."""
    drawn: Dict[str, Dict[str, np.ndarray]] = {}
    out = {}
    for spec in specs:
        gen = spec["generator"]
        if gen not in drawn:
            drawn[gen] = generator(gen).fields(n, seed)
        values = drawn[gen][spec["name"]]
        if "format" in spec:
            vocab = np.array([spec["format"].format(i) for i in range(int(values.max()) + 1)])
            values = vocab[values]
        out[spec["name"]] = values
    return out
