"""Hand-written CUDA kernels for Hopper (``csrc/``), bound with ctypes
(``_build.py``), beside their plain PyTorch twins (``ref.py``); ``ops``
is the public dispatch."""
