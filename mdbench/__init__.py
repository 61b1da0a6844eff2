"""The benchmark of meng_zhang_tpu_torch: one cell, one run, one JSON
line. `python -m mdbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the checkout's root (see BENCHMARK.json)."""
