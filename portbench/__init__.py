"""portbench: the benchmark of tpurpn_torch (see BENCHMARK.json and PERF.md).

Run a cell from the root of a checkout:

    python3 portbench/run.py --workload serve-b128 --seed 7 --seconds 20 --trace 0
"""
