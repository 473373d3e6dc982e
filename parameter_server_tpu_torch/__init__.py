"""PyTorch/CUDA port of ``parameter_server_tpu``.

The package mirrors the JAX package's layout and names so each module
has an obvious counterpart. It imports ``torch`` and numpy only: nothing
of JAX and nothing of the JAX package. Entry points run on the CUDA
device unless the caller asks for the CPU (see :func:`device.resolve`).
"""
