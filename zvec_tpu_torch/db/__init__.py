"""Host-side database layer: collections, segments, durability, filters.

The counterpart of the reference's `src/db/` (C++), copied from `zvec_tpu.db`
with its imports re-pointed: the column store, WAL, version manifest, pk map
and delete store run on the host; vector data is streamed into device-resident
segment state and all scoring happens in `zvec_tpu_torch.ops`.
"""

from .collection_impl import CollectionImpl

__all__ = ["CollectionImpl"]
