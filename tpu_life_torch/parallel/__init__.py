"""Row sharding over several devices (from ``tpu_life/parallel``): the
mesh of shard devices and the halo exchange between neighbouring shards."""
