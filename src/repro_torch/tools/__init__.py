"""The port's tools, each run as ``python -m repro_torch.tools.<name>``:
the twins of the JAX package's tools outside ``src/`` (``kernel_bench``,
``roofline``, ``colocation``, ``shakeout_decode``, ``shakeout_models``,
``quickstart``, ``serving_demo``), with what they share in ``common``."""
