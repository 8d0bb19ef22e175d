"""The control: the plain reference in the program's place, one precision
below the one the configurations state.

The configurations state float32 distances (fp32 codes, products exact in
float32: the port's flat scan keys by split-TF32 and re-scores in fp32, its
beam and blockwise scan run float32 products with TF32 off). The step that
would tempt a later change is TF32 products: on the card the control runs
them on the tensor cores (`allow_tf32`), on the CPU it rounds the inputs as
they would be. It answers each call with the top-k rows by its TF32
distances and those distances as scores, under the call's filter, and the
comparison of `check.py` has to find it not correct. It has the interface
of the harness's system under test (`port.PortSystem`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .exact import sq_l2_f32
from .filter import row_mask


class Tf32Control:
    def __init__(self, config: dict, traffic: dict, workdir: Path, device: torch.device):
        self.k, self.device = traffic["topk"], device
        self._masks: Dict[tuple, torch.Tensor] = {}

    def setup(self, x: np.ndarray, fields: Dict[str, np.ndarray]) -> dict:
        self.x = torch.from_numpy(x).to(self.device)
        self.xn = (self.x * self.x).sum(1)
        self.fields = fields
        return {"build_s": 0.0, "build_times": {}}

    def _mask(self, clauses):
        if not clauses:
            return None
        if clauses not in self._masks:
            keep = row_mask(clauses, self.fields, self.x.shape[0])
            self._masks[clauses] = torch.from_numpy(keep).to(self.device)
        return self._masks[clauses]

    def query(self, call, queries: np.ndarray):
        q = torch.from_numpy(queries[call.lo : call.hi]).to(self.device)
        d = sq_l2_f32(q, self.x, self.xn, tf32_products=True)
        mask = self._mask(call.clauses)
        if mask is not None:
            d.masked_fill_(~mask[None, :], float("inf"))
        s, i = torch.topk(d, self.k, dim=1, largest=False)
        i = torch.where(s.isfinite(), i, torch.full_like(i, -1))
        return i.cpu().numpy(), s.double().cpu().numpy()

    @staticmethod
    def keep(result):
        return result

    @staticmethod
    def answers(kept, nq: int):
        return kept

    @staticmethod
    def engine_secs() -> float:
        return 0.0

    @staticmethod
    def beam_steps() -> int:
        return 0

    @staticmethod
    def reset_beam_steps() -> None:
        pass

    def close(self) -> None:
        self.x = self.xn = None
        self._masks.clear()
