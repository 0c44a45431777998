"""Command-line entry points of the port: ``python -m tpusr_torch.cli``
(``tpusr_torch.cli.__main__``)."""
