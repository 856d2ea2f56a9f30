"""Entry points (port of ``repro.launch``): the LM serving driver."""
