"""Simulation and evaluation helpers (copies of the JAX package's
``utils.simulate`` and ``utils.metrics``)."""
