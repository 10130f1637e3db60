"""The H100 benchmark of `tepose_tpu_torch`.

One command runs one cell of `BENCHMARK.json`:

    python -m bench_h100.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name under this folder: the model
configuration in `configs/<config>.json`, the traffic mix in
`traffic/<traffic>.json` (read by the driver it names, `drivers/<driver>.py`),
each per-layer metric's reader in `metrics/<metric>.py` and each cell's
correctness limits in `limits/<workload>.json`. `reference/` is the plain
PyTorch reference that decides `correct`; it imports nothing of the program.
"""
