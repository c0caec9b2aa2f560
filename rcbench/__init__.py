"""The benchmark of the PyTorch and CUDA port (`repro_torch`): RcLLM
ranking traffic through the port's session server on one card, judged
against a plain PyTorch reference.  `BENCHMARK.json` at the repository
root names its cells; `python3 rcbench/run.py --workload <cell> ...`
runs one."""
