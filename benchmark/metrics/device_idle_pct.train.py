"""`harness/readers.py::idle_pct` in a train cell."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
