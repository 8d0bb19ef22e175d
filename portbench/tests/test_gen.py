"""The generators: the same seed gives the same rows, queries, fields and
calls; another seed or stream gives others."""

import numpy as np
import pytest
import torch

from portbench.gen import FIELDS, QUERIES, ROWS, generator, substream
from portbench.gen import calls as calls_mod
from portbench.gen.fields import make_fields
from portbench.gen.fields_arrays import fields as fields_arrays
from portbench.gen.gaussian import vectors as gaussian

BIG = 2**31 + 7  # seeds may pass 32 signed bits


@pytest.mark.parametrize("seed", [0, 12345, BIG, 2**40 + 3])
def test_gaussian_repeats_per_seed(seed):
    cpu = torch.device("cpu")
    a = gaussian(300, 16, seed, ROWS, cpu)
    b = gaussian(300, 16, seed, ROWS, cpu)
    assert a.dtype == torch.float32 and a.shape == (300, 16)
    assert torch.equal(a, b)
    assert not torch.equal(a, gaussian(300, 16, seed + 1, ROWS, cpu))
    assert not torch.equal(a[:10], gaussian(10, 16, seed, QUERIES, cpu))
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.05


def test_generators_found_by_name():
    assert generator("gaussian").vectors is gaussian
    assert generator("fields_arrays").fields is fields_arrays
    with pytest.raises(ImportError):
        generator("no_such_generator")


def test_substreams_differ():
    assert len({substream(BIG, s) for s in (ROWS, QUERIES, FIELDS)}) == 3
    assert substream(BIG, ROWS) != substream(BIG + 1, ROWS)
    assert 0 <= substream(BIG, ROWS) < 2**64


def test_fields_arrays_repeat_per_seed():
    a, b = fields_arrays(5000, BIG), fields_arrays(5000, BIG)
    assert np.array_equal(a["tag"], b["tag"]) and np.array_equal(a["price"], b["price"])
    assert a["tag"].min() == 0 and a["tag"].max() == 9
    assert 0.0 <= a["price"].min() and a["price"].max() < 1.0
    assert not np.array_equal(a["price"], fields_arrays(5000, BIG + 1)["price"])


def test_make_fields_formats_strings():
    specs = [{"name": "tag", "type": "STRING", "generator": "fields_arrays", "format": "t{}"},
             {"name": "price", "type": "DOUBLE", "generator": "fields_arrays"}]
    got = make_fields(specs, 1000, 5)
    raw = fields_arrays(1000, 5)
    assert list(got["tag"][:5]) == [f"t{v}" for v in raw["tag"][:5]]
    assert np.array_equal(got["price"], raw["price"])


MIX = {"batch": 256, "topk": 10, "filter": [
    {"field": "tag", "op": "=", "value": {"cycle": [f"t{i}" for i in range(10)]}},
    {"field": "price", "op": "<", "value": 0.5}]}


def test_calls_cycle_slices_and_filters():
    assert calls_mod.period(MIX, 10240) == 40
    c = calls_mod.call(MIX, 10240, 43)
    assert (c.lo, c.hi) == (3 * 256, 4 * 256)
    assert c.clauses == (("tag", "=", "t3"), ("price", "<", 0.5))
    assert calls_mod.render(c.clauses) == "tag = 't3' AND price < 0.5"
    assert c.combo == 3 and calls_mod.call(MIX, 10240, 83).combo == 3
    seq = calls_mod.calls(MIX, 10240, 0, 80)
    assert [x.combo for x in seq[:40]] == [x.combo for x in seq[40:]]
    assert len({x.combo for x in seq}) == 40


def test_calls_without_filter():
    mix = {"batch": 1024, "topk": 10, "filter": None}
    assert calls_mod.period(mix, 10240) == 10
    c = calls_mod.call(mix, 10240, 12)
    assert (c.lo, c.hi, c.clauses, c.combo) == (2048, 3072, None, 2)
    assert calls_mod.render(None) is None
    with pytest.raises(ValueError):
        calls_mod.call({"batch": 20000, "topk": 10}, 10240, 0)
