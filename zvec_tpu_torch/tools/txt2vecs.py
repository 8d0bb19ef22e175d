"""txt2vecs: text vector records -> binary dataset files.

Rebuilds the reference converter `tools/core/txt2vecs.cc:26-34` (flags) /
`tools/core/txt_input_reader.h:138-305` (line formats) for this repo's tool
chain. Line formats are reference-parity:

  dense:   key<first_sep>v1<second_sep>v2<second_sep>...
  sparse:  key<first_sep>count<first_sep>i1 i2 i3:v1 v2 v3
           (indices strictly ascending; ':' splits index list from values)

Outputs map onto the formats the repo's build/recall/bench tools read
(`tools/io.py` fvecs/ivecs/bvecs, npy/npz) instead of the reference's
proprietary keyed .vecs container:

  dense  -> .fvecs (float) / .ivecs (int16/int32) / .bvecs (int8/binary),
            plus <output>.keys.npy when keys are not the identity 0..N-1
  sparse -> .npz with keys / indptr / indices / values (CSR; rows round-trip
            to the {dim: value} dicts the Collection API takes)

Usage:
  python -m zvec_tpu_torch.tools.txt2vecs --input in.txt --output out.fvecs \
      --dimension 128 [--vector-type dense|sparse] [--type float|int8|...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .io import write_vecs

__all__ = ["convert_dense", "convert_sparse", "main"]

_DENSE_DTYPES = {
    "float": np.float32,
    "double": np.float64,
    "int16": np.int16,
    "int8": np.int8,
    "binary": np.uint8,
}


def _split_records(path: str, first_sep: str):
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(first_sep)
            if len(parts) < 2:
                print(f"skip record : {line}", file=sys.stderr)
                continue
            yield parts


def convert_dense(
    path: str, dimension: int, first_sep: str = ";", second_sep: str = " ",
    dtype: str = "float",
):
    """Parse dense records -> (keys (N,) uint64, features (N, dim))."""
    np_dtype = _DENSE_DTYPES[dtype]
    keys, rows = [], []
    for parts in _split_records(path, first_sep):
        vals = np.array(parts[1].split(second_sep), dtype=np.float64)
        if vals.shape[0] != dimension:
            print(
                f"dim mismatch ({vals.shape[0]} != {dimension}) key: {parts[0]}",
                file=sys.stderr,
            )
            continue
        keys.append(int(parts[0]))
        rows.append(vals)
    feats = np.asarray(rows, dtype=np.float64)
    if np_dtype != np.float64:
        feats = feats.astype(np_dtype)
    return np.asarray(keys, dtype=np.uint64), feats


def convert_sparse(
    path: str, first_sep: str = ";", second_sep: str = " ",
):
    """Parse sparse records -> (keys, indptr, indices, values) CSR arrays.
    Reference format check parity (`txt_input_reader.h`): the index and value
    lists must agree in length and indices must be strictly ascending."""
    keys, indptr, idx_all, val_all = [], [0], [], []
    for parts in _split_records(path, first_sep):
        body = parts[2] if len(parts) >= 3 else parts[1]
        halves = body.split(":")
        if len(halves) != 2:
            print(f"load sparse failed for key: {parts[0]}", file=sys.stderr)
            raise ValueError(f"malformed sparse record for key {parts[0]}")
        idx = np.array(halves[0].split(second_sep), dtype=np.uint32)
        val = np.array(halves[1].split(second_sep), dtype=np.float32)
        if idx.shape[0] != val.shape[0]:
            raise ValueError(
                f"sparse feature count ({val.shape[0]}) != index count "
                f"({idx.shape[0]}) key : {parts[0]}"
            )
        if idx.shape[0] > 1 and not np.all(idx[1:] > idx[:-1]):
            raise ValueError(f"sparse indices not ordered, key : {parts[0]}")
        keys.append(int(parts[0]))
        idx_all.append(idx)
        val_all.append(val)
        indptr.append(indptr[-1] + idx.shape[0])
    return (
        np.asarray(keys, dtype=np.uint64),
        np.asarray(indptr, dtype=np.int64),
        np.concatenate(idx_all) if idx_all else np.zeros(0, np.uint32),
        np.concatenate(val_all) if val_all else np.zeros(0, np.float32),
    )


def sparse_rows(npz_path: str):
    """Load a txt2vecs sparse .npz back into Collection-API form:
    (keys, [{dim: value}, ...])."""
    z = np.load(npz_path)
    keys, indptr = z["keys"], z["indptr"]
    indices, values = z["indices"], z["values"]
    rows = [
        {
            int(i): float(v)
            for i, v in zip(
                indices[indptr[r] : indptr[r + 1]],
                values[indptr[r] : indptr[r + 1]],
            )
        }
        for r in range(len(keys))
    ]
    return keys, rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="txt2vecs", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--input", required=True, help="txt input file")
    ap.add_argument("--input-first-sep", default=";")
    ap.add_argument("--input-second-sep", default=" ")
    ap.add_argument("--output", required=True, help="binary output file")
    ap.add_argument("--type", default="float", choices=sorted(_DENSE_DTYPES))
    ap.add_argument("--dimension", type=int, default=256)
    ap.add_argument("--vector-type", default="dense", choices=["dense", "sparse"])
    args = ap.parse_args(argv)

    if args.vector_type == "sparse":
        keys, indptr, indices, values = convert_sparse(
            args.input, args.input_first_sep, args.input_second_sep
        )
        out = args.output if args.output.endswith(".npz") else args.output + ".npz"
        np.savez(out, keys=keys, indptr=indptr, indices=indices, values=values)
        print(f"wrote {len(keys)} sparse records -> {out}")
        return 0

    keys, feats = convert_dense(
        args.input, args.dimension, args.input_first_sep,
        args.input_second_sep, args.type,
    )
    write_vecs(args.output, feats)
    ident = np.arange(len(keys), dtype=np.uint64)
    if len(keys) and not np.array_equal(keys, ident):
        np.save(args.output + ".keys.npy", keys)
        print(f"keys are non-identity -> {args.output}.keys.npy")
    print(f"wrote {feats.shape} {args.type} records -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
