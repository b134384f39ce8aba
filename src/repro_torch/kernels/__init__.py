"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the public surface; ``attention_decode`` holds the decode
kernel's wrapper, plain version and tolerance; ``_build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""
