"""Entries: how a cell drives the program.  ``workloads/<cell>.json`` names
one by its module's name; each has ``setup(cell, seed, device) -> Session``
(`portbench.harness`)."""
