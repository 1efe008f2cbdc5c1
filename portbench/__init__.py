"""portbench: the benchmark of mpv_frame_interpolator_tpu_torch, the
PyTorch and CUDA interpolator, on NVIDIA cards.

``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Each configuration, traffic mix and metric is a file of its own here,
found by the name ``BENCHMARK.json`` gives it (``spec.py``).
"""
