"""`harness/readers.py::mfu_pct` in a predict cell."""

from benchmark.harness.readers import mfu_pct as read  # noqa: F401
