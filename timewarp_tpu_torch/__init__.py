"""timewarp_tpu_torch — the PyTorch/CUDA port of ``timewarp_tpu``.

The JAX package ``timewarp_tpu`` is the reference; this package runs the
same scenarios on PyTorch tensors and one NVIDIA H100, held bit-for-bit
against the reference (tests/test_torch_*.py). It imports ``torch`` and
never ``jax``, and nothing of ``timewarp_tpu``: what it needs from there
it keeps as its own copy, module for module (``core/``, ``ops/``,
``trace/``, ``net/``, ``models/``, ``interp/torch_engine/``).

The kernels of the path — fire-compaction and mailbox insertion — are
CUDA C++ for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``utils/build.py``). Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version. The engine is
``timewarp_tpu_torch.interp.torch_engine.engine.TorchEngine``.
"""
