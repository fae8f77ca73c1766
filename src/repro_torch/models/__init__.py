"""Models (port of ``repro/models``: the encoder mode of the
transformer, with its layers and attention — the HI²_sup term scorer)."""
