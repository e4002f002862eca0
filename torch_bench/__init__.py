"""The benchmark of the PyTorch and CUDA port, driven by ``BENCHMARK.json``.

Each piece lives in a file of its own, found by the name the JSON gives:

- ``configs/<config>.json``: a configuration as it is run (settings, the
  data's parameters, what was assumed and reduced, the correctness limits);
- ``traffic/<traffic>.json``: a traffic mix (loop, clients, pool, entry);
- ``data/<kind>.py``: the seeded generator a configuration's data names;
- ``entries/<entry>.py``: how a request calls the port;
- ``reference/<method>.py``: the plain float32 reference of a method;
- ``metrics/<metric>.py``: the reader of a per-layer metric;
- ``rooflines/<kernel>.py``: a kernel's least bytes and operations.

``run.py`` is the command, ``readings.py`` takes the readings the
correctness limits are set from, ``tests/`` holds the CPU checks.
"""
