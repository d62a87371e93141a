"""Per-layer metric readers: ``<metric>.py`` (a dot of the name is ``_``
here) has ``read(ctx) -> float | None``; ``None`` where the cell gives the
reader nothing to read, and the run leaves the metric out.  ``ctx`` holds
the cell's ``kind``, the profiler's ``trace`` (`portbench.trace.Trace`),
the number of ``traced`` calls, the host ``dispatch_s`` of the untraced
calls, the entry's ``work`` counts and the window's ``rate`` of units."""
