"""tpu_life_torch: the PyTorch / CUDA port of ``tpu_life``.

A second package beside the JAX one, for an NVIDIA H100.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``tpu_life``: where it
needs a module of the JAX package it keeps its own trimmed copy under the
same module name (``models.rules``, ``ops.boolmin``, ``ops.reference``,
``io.codec``, ``utils``).  Its kernels are written by hand for Hopper
(``csrc/``), each beside a plain PyTorch version (``kernels/``).

Entry point: ``python -m tpu_life_torch run`` — the reference contract,
on the card unless ``--device cpu`` is asked for.
"""
