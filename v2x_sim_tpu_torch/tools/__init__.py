"""Command-line tools: ``python -m v2x_sim_tpu_torch.tools.<name>``. Each
tool's ``main(argv=None)`` also runs in-process."""
