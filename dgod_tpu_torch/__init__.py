"""dgod_tpu_torch — the PyTorch/CUDA port of dgod_tpu for NVIDIA Hopper.

A second package beside `dgod_tpu` (JAX/Flax/Pallas), mirroring its layout
module for module. It imports torch and numpy only: nothing of JAX, Flax or
`dgod_tpu`. Every Pallas kernel on the ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc at first use (`ops/_build.py`) and
kept beside a plain PyTorch version of the same function; a wrapper sends a
CPU tensor to the plain version and a CUDA tensor to the kernel.

Entry points run on the card unless the caller passes `device="cpu"`
(`device.py::resolve_device`). Importing the package imports no torch:
a train loader's child process imports the data modules only.
"""
