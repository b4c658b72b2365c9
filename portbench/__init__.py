"""The benchmark of the PyTorch and CUDA port (``monoforce_tpu_torch``) on
one H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.
See ``BENCHMARK.json`` at the repository's root for the cells and
metrics, and ``PERF.md`` for why each exists."""
