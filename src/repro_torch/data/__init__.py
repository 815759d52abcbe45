"""Synthetic LM data (port of ``repro.data``)."""
