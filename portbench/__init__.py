"""The benchmark of ``icp_slam_yolo_tpu_torch`` on one NVIDIA H100.

One run of one cell: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  Everything a cell needs is found by name:
``workloads/<cell>.json`` names its configuration (``configs/<name>.json``),
its traffic (``traffic/<name>.json``), its entry (``entries/<name>.py``) and
the limits of its check; each per-layer metric is read by
``metrics/<metric>.py``.  ``reference/`` holds the plain reference the check
compares with; it imports nothing of the program.
"""
