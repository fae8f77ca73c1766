"""Port of ``repro/core``: KMeans, BM25, selectors, inverted lists,
pruning, codecs, the staged query-execution engine, the hybrid index
build and search, and the mutable index (:mod:`.segments`: delta
segment, tombstones, compaction)."""
