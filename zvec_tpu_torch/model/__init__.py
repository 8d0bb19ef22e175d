from .collection import Collection
from .doc import Doc
from .schema import CollectionSchema, CollectionStats, FieldSchema, VectorSchema

__all__ = [
    "Collection",
    "Doc",
    "CollectionSchema",
    "CollectionStats",
    "FieldSchema",
    "VectorSchema",
]
