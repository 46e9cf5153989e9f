"""The benchmark of the PyTorch and CUDA port (``chess_vision_tpu_torch``):
``python3 -m benchmarks.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
