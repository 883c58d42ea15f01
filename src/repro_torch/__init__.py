"""PyTorch/CUDA port of the QLM serving stack (``src/repro`` is the JAX
reference).  The port imports ``torch`` and nothing of ``repro`` or JAX:
the framework-neutral modules it needs are its own copies."""
