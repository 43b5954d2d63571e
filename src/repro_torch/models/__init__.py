"""Model layers and the dense transformer (port of ``repro.models``)."""
