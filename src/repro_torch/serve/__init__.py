"""The port's serving layer: the dense continuous-batching engine and
the admission-controlled batcher."""
