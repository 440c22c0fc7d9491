"""`harness/readers.py::mfu_pct` in a train cell."""

from benchmark.harness.readers import mfu_pct as read  # noqa: F401
