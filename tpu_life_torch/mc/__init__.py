"""The counter-based PRNG (a trimmed copy of ``tpu_life/mc/prng.py``)."""
