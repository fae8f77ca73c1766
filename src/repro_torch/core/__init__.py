"""Port of ``repro/core``: KMeans, BM25, selectors, inverted lists,
pruning, codecs, the staged query-execution engine and the hybrid index
build and search."""
