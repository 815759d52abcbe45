"""Compressors, EF-BV and its tuning theory (port of ``repro.core``)."""
