"""Launchers (port of ``repro/launch``: single-device serving, its
runtime, and the width tuner)."""
