"""AdamW and learning-rate schedules (port of ``repro.optim``)."""
