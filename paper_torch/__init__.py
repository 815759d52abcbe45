"""The paper's experiments (Figure 2, Figure 3, Table 3) on the PyTorch/CUDA
port: counterparts of ``benchmarks/paper_fig2.py``, ``paper_fig3.py`` and
``paper_tab3.py`` that import nothing of JAX or of the JAX package.

Run from the repository root, on the card (the default) or the CPU:

    python -m paper_torch.paper_tab3
    python -m paper_torch.paper_fig2 [--full] [--device cpu]
    python -m paper_torch.paper_fig3 [--full] [--device cpu]

Each prints the JAX scripts' CSV rows (``name,us_per_call,derived``).
"""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
