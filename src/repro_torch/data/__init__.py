"""Data (port of ``repro/data``: the synthetic retrieval corpus, the
sharded pipeline, ``pipeline.py``, and the hash tokenizer,
``tokenizer.py``)."""
