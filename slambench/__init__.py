"""The benchmark of the PyTorch and CUDA port (`voxelslam_tpu_torch`).

`python -m slambench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line (see `run.py`).
"""
