"""The benchmark of ``raytracer_tpu_torch``, the PyTorch and CUDA ray tracer.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  See
``harness.py``."""
