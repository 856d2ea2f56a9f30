"""The LM stack (port of ``repro.models``): configuration, parameter
specs, layers and the dense decoder-only transformer."""
