"""The benchmark of ``shiftnet_tpu_torch``, the PyTorch / CUDA port, on
NVIDIA H100 cards: ``python -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.

Driven by data: a cell names a configuration file (``configs/``), a
traffic mix (``traffic/<mix>.json``, read by ``generator.py``) and its
limits (``limits/<cell>.json``); a per-layer metric is a reader of its own
(``layer_metrics/<metric>.py``).  A new cell or metric is new files and
new ``BENCHMARK.json`` entries, with no other edit."""
