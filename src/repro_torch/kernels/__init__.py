"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the public surface; ``attention_decode`` holds the decode
kernel's wrapper, plain version and tolerance; ``segmented_update``
the optimizer kernels' wrappers, plain version and host glue; ``ref``
the shared optimizer math; ``_build`` compiles ``csrc/*.cu`` with
``nvcc`` at first use.
"""
