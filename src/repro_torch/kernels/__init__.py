"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
(``ref.py``) and wrappers (``pack.py``, ``ops.py``); ``build.py`` compiles
``csrc/`` at first use."""
