"""mcmtt_opticalflow_tpu_torch — the tracking engine on PyTorch and CUDA.

A port of ``mcmtt_opticalflow_tpu`` (JAX, the reference) to PyTorch on an
NVIDIA Hopper card.  Each module sits at the same relative path as its JAX
counterpart.  Device code is plain PyTorch, except the LK pyramid-level
kernels (the batched and serial variants), which are hand-written CUDA
(``ops/csrc/lk_level.cu``).  The host modules that never touched jax are
carried over as copies (``config.py``, ``main.py``,
``geometry/tsai_np.py``, ``models/trees.py``, ``eval/clearmot.py``,
``eval/experiment.py``, ``data/images.py``, ``data/pets.py``,
``utils/timing.py::StageTimer``, ``utils/{logging,colors,math,dumps}.py``,
``viz/``).  The sub-packages export the names the JAX package's do.

The package imports torch, numpy and scipy only, never jax.
"""

import torch

__version__ = "0.1.0"

# The BLS weight matvecs (models/mwcp.py) and the SG einsum
# (ops/sgsmooth.py) need full float32: TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mcmtt_opticalflow_tpu_torch.config import (  # noqa: F401,E402
    EngineConfig,
    Tracker2DConfig,
    Associator3DConfig,
    SolverConfig,
    EvalConfig,
)
