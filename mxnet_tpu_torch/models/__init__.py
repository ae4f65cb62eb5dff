"""Models of the port: ``transformer`` (config, init, layer norm) and
``gpt`` (prefill, cached decode, ``generate``)."""
from . import transformer  # noqa: F401
from . import gpt  # noqa: F401
