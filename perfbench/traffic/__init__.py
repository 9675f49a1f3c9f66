"""Traffic: each kind a generator (``<kind>.py``), each mix its parameters (``<mix>.json``)."""
