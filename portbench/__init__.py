"""The benchmark of the PyTorch and CUDA port (`spectrogram_cube_clustering_tpu_torch`).

Run one cell: `python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
"""
