"""The parts of the JAX package's decision rule (``repro/core``) that
the serving plan uses, copied so the port imports nothing of it."""
