"""Scalar field `row_id`: each row's number, the generator a configuration's
field names by `"generator": "row_id"`.

VectorDBBench's filtered-search cases (zilliztech/VectorDBBench, the "Filter
1%" and "Filter 99%" cases such as `Performance768D1M99P`) give every row an
int field equal to its id and ask for the top-k under `id >= int(rate * N)`,
so that a share 1 - rate of the rows passes whatever the vectors hold. The
values do not depend on the seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def fields(n: int, seed: int) -> Dict[str, np.ndarray]:
    return {"row_id": np.arange(n, dtype=np.int64)}
