"""Autotune: only the tuned-configuration record is ported yet."""

from tpu_life_torch.autotune.space import TunedConfig, tuned_record

__all__ = ["TunedConfig", "tuned_record"]
