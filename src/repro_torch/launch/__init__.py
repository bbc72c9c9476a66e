"""Launchers (the port of ``repro.launch``): ``mesh`` (the H100 hardware
model), ``train`` and ``serve``."""
