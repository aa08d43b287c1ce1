"""The benchmark of ``howl_tpu_torch``: ``python3 -m benchmark.run``, driven
by the root ``BENCHMARK.json`` (see ``harness.py``)."""
