"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
(``ref.py``) and wrappers (``pack.py``, ``threefry.py``,
``ops.py``); ``build.py`` compiles ``csrc/`` at first use.

``LAUNCHES`` counts kernel launches by kernel name.  A wrapper adds one
where it launches its kernel and nowhere else (its plain version on a CPU
tensor counts nothing), so a run can show that its main path went through
the kernels.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"pack_update": 0, "qsgd_pack_update": 0,
                            "randk_update": 0, "threefry_uniform": 0,
                            "block_topk": 0, "efbv_update": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
