"""The comparison that decides `correct`, on whole runs of the harness at a
tiny size on the CPU (the look for a card skipped): sound runs come out
correct, and runs with the timed path broken underneath come out not
correct, once for each fault the cells can have."""

import os

os.environ.setdefault("ZVEC_TORCH_DEVICE", "cpu")  # the port on the CPU, before it is imported

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from portbench.run import run  # noqa: E402

SEED = 2**31 + 99
CELLS = ["sift1m_flat_l2.batch"]


def go(root, cell):
    result, lines = run(root, cell, SEED, 0.3, trace=False, device="cpu")
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result = go(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert result["metrics"]["recall_at_10"]["value"] == 1.0


def _break_engine(monkeypatch, alter):
    """Every engine search returns alter(sims, idx) in place of its answer."""
    from zvec_tpu_torch.core.interface import VectorIndexEngine

    original = VectorIndexEngine.search_async

    def broken(self, queries, topk, mask=None, param=None):
        fin = original(self, queries, topk, mask, param)

        def finalize():
            sims, idx = fin()
            return alter(np.array(sims), np.array(idx))

        return finalize

    monkeypatch.setattr(VectorIndexEngine, "search_async", broken)


def answer_altered(sims, idx):
    idx[:, 0] = (idx[:, 0] + 1) % 3000  # another row's pk under the first answer's score
    return sims, idx


def score_altered(sims, idx):
    return sims * (1 + 1e-4), idx  # each score off by a ten-thousandth


def half_left_out(sims, idx):
    half = idx.shape[0] // 2
    idx[half:] = -1
    sims[half:] = -np.inf
    return sims, idx


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("alter", [answer_altered, score_altered, half_left_out], ids=lambda f: f.__name__)
def test_broken_engine_is_not_correct(tiny_root, monkeypatch, cell, alter):
    _break_engine(monkeypatch, alter)
    result = go(tiny_root, cell)
    assert not result["correct"], result["checks"]


def test_pk_mapping_broken_is_not_correct(tiny_root, monkeypatch):
    from zvec_tpu_torch.db.collection_impl import CollectionImpl

    original = CollectionImpl._resolve_pks

    def shifted(self, ids, segs):
        pks = np.array(original(self, ids, segs), dtype=object)
        pks[:, 1] = pks[:, 0]  # the second answer repeats the first's pk
        return pks

    monkeypatch.setattr(CollectionImpl, "_resolve_pks", shifted)
    result = go(tiny_root, "sift1m_flat_l2.batch")
    assert not result["correct"]
