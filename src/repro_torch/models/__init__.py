"""The port's model: config, GQA attention, the dense stack, weights."""
