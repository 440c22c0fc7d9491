"""Baselines the port is measured against: the reference's own graph
(``torch_ref.py``), timed on the same card."""
