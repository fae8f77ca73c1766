"""Data (port of ``repro/data``: the synthetic retrieval corpus)."""
