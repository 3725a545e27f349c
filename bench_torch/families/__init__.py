"""The program side of each configuration family, one module a family,
found by the configuration's ``family`` (``harness/program.py``):
``net(config, traffic)``, ``loss(config)`` and ``small(config, traffic)``."""
