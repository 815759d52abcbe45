"""The EF-BV training step (port of ``repro.train``)."""
