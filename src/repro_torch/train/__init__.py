"""Training of the port (a copy of ``repro/train``)."""
