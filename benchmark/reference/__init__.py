"""The plain float32 reference of the benchmark's cells.

Plain PyTorch and NumPy, written from the published descriptions: nothing here imports
the port, the JAX package or JAX, and nothing takes what the port made. The benchmark
hands both sides the same seeded weights and inputs; the reference works out again
whatever the port derives from them (quantized rows, scales, optimizer state).
"""
