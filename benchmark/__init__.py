"""The benchmark of pitchvis_tpu_torch on NVIDIA H100 cards (see PERF.md).

    python3 -m benchmark --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
