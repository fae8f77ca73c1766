"""Data (port of ``repro/data``: the synthetic retrieval corpus and the
sharded pipeline, ``pipeline.py``)."""
