"""`harness/readers.py::idle_pct` in a predict cell."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
