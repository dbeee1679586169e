"""PyTorch/CUDA port of the HLA system.

The JAX package ``repro`` stays the reference; this package has the same
module layout and imports nothing from it.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version instead.
"""
