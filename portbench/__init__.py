"""Benchmark of the PyTorch / CUDA port (``repro_torch``): inference
queries over deduplicated LM variants served out of SQLite on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
"""
