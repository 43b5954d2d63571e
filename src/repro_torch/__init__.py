"""repro_torch — the PyTorch/CUDA port of the DiP reproduction (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``core``, ``configs``, ``kernels``, ``api``, ``models``,
``optim``, ``data``, ``checkpoint``, ``serving``, ``runtime``, ``launch``)
and carries the serving and training paths of the dense family: every
projection runs a hand-written CUDA kernel that multiplies straight from
DiP-permutated weight storage (``kernels/csrc/dip_matmul.cu``), chunked
prefill runs a hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``), and the training loss runs a
hand-written fused lm_head + cross-entropy kernel
(``kernels/csrc/lm_head_ce.cu``).

It imports ``torch`` and never ``jax`` or ``repro``.  Entry points
(``Server``, ``Engine``, ``Trainer``, ``init_params``, ``launch.serve``,
``launch.train``) run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
