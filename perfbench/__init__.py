"""The benchmark of ``tpu_life_torch``: see README.md."""
