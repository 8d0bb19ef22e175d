"""Gaussian rows and queries: the generator a configuration names by
`"vectors": "gaussian"`.

Copied from `bench.py:309-312`: i.i.d. standard normal float32 vectors for
the corpus and for the queries (there, `rng.standard_normal((N, D),
dtype=np.float32)` after the queries of `default_rng(0)`). Here each is drawn
on the device by a `torch.Generator` seeded from the run's seed, in one call,
so that set-up does not spend seconds in numpy; the two draws are apart
(streams ROWS and QUERIES of `gen.substream`).
"""

from __future__ import annotations

import torch

from . import substream


def vectors(n: int, dim: int, seed: int, stream: int, device: torch.device) -> torch.Tensor:
    """(n, dim) float32 standard normal draws of `stream` of the run `seed`,
    on `device`. The same seed, stream and device give the same tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(substream(seed, stream))
    return torch.randn((n, dim), generator=gen, device=device, dtype=torch.float32)
