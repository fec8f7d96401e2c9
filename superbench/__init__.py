"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` a run
(``python3 superbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``)."""
