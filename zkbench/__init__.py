"""The benchmark of keyless_zk_tpu_torch, the Aptos Keyless prover service
on NVIDIA GPUs. `python -m zkbench --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell of BENCHMARK.json once; see run.py."""
