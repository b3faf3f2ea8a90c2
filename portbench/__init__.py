"""The benchmark of the PyTorch and CUDA port (``partitionedarrays_tpu_torch``).

``python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card; see ``portbench/README.md``.
"""
