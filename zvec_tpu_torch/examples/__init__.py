"""Runnable examples of the port, each `python -m zvec_tpu_torch.examples.<name>`:

  quickstart          — a collection with scalar fields, insert, filtered search
  hybrid_multivector  — BM25 sparse + dense fields fused by RrfReRanker
  quantized_groupby   — an INT8 cosine HNSW index, refine, filter and group-by
  mesh_sharding       — a FLAT collection split over 8 corpus shards

They are `examples/*.py` of the JAX package, run on this package's device (the
card when there is one). Each `main(path=None)` works in a fresh temporary
directory unless given one, prints what the JAX package's example prints, and
returns the ids it printed.
"""
