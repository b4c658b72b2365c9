"""The benchmark's plain reference: a frozen copy of the PyTorch port's
plain code (no kernel, no cache), as it stood when the benchmark was
written.

It imports neither JAX, the JAX package nor anything of the program under
test, and takes nothing the program made: the benchmark hands both sides
the same seeded weights and inputs, and the reference works out the rest
again.  Each module names the port's module it copies.
"""
