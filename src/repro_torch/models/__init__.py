"""Model configs and the dense model family (port of ``repro.models``)."""
