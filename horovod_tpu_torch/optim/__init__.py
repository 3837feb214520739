"""Optimizer wrappers of the port (``DistributedOptimizer``)."""
