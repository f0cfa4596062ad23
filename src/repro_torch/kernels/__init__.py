"""Hand-written CUDA kernels for Hopper (``csrc/``), their Python wrappers,
and the plain PyTorch versions they are held against (``ref``).

Importing a module here builds nothing: the kernels build at their first
launch on the card (``_build.load_kernels``)."""
