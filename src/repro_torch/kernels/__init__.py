"""Hand-written Hopper kernels, their wrappers, loader and plain versions.

Importing this package builds nothing: ``build.load`` compiles a kernel's
CUDA source at its first launch.
"""
