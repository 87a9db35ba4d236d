"""Binary matmul / conv kernels: CUDA sources in ``csrc/``, their ctypes
wrappers, the plain PyTorch versions (``ref.py``) and the dispatching
entry points (``ops.py``). Nothing is built at import time."""
