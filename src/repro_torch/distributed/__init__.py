"""Wire codecs and compressed cross-worker aggregation (port of
``repro.distributed``)."""
