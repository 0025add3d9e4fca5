"""Benchmark of the PyTorch and CUDA package ``torch_asg_tpu_torch`` on the
NVIDIA H100.  ``python3 bench_h100/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
