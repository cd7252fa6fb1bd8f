"""The port's twins of the JAX package's ``recipes/`` scripts that need no ``bench.py``."""
