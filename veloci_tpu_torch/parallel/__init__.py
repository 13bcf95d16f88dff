"""The document-sharded mesh: :mod:`.sharding` (the device grid, its two
collectives, the sharded postings and dictionary and their shard steps),
:mod:`.mesh_executor` (``search`` and ``search_batch`` over an attached
mesh) and :mod:`.shards` (separate indices served as one)."""
