"""The benchmark of quake_tpu_torch: one cell (a configuration under a
traffic mix) per run of `python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`, driven by BENCHMARK.json and the data
files under this directory. It imports neither JAX nor quake_tpu."""
