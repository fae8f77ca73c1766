"""Port of ``repro/core``: selectors, inverted lists, codecs, the staged
query-execution engine and the hybrid index search."""
