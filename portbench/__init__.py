"""The benchmark of the PyTorch and CUDA port (``quadrotor_manipulator_mppi_tpu_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; see ``core.py``.
"""
