"""Models of the port: ``transformer`` (config, init, layer norm) and
``gpt`` (prefill, cached decode, ``generate``)."""
