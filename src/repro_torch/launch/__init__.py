"""Launchers (port of ``repro/launch``: single-device serving)."""
