"""Observability for the port: the parts the resilience plane needs.

Counterpart of ``ramba_tpu/observe/``.  Ported so far: the event stream
(``events``: in-memory ring, optional JSONL file), the counter registry
(``registry``), the observer-tax ledger (``observer``), health records
(``health``) and the kernel cost ledger with its slow-flush sentinel
(``ledger``).  Flush attribution, SLOs, telemetry export, fleet snapshots
and profiler hooks come with the observability queue.

Environment variables:

* ``RAMBA_TRACE=<path>`` — append one JSON object per event to ``<path>``
  (``<path>.rank<i>`` per process when a process group has more than one).
* ``RAMBA_TRACE_RING=<n>`` — in-memory ring size (default 256; the ring is
  always on, file output only when RAMBA_TRACE is set).
* ``RAMBA_TRACE_SAMPLE=<N>`` — head-sample the JSONL trace file to
  1-in-N trace chains; chains that end in an incident flush their
  buffered span chain (the tail latch, ``events``).
* ``RAMBA_PERF`` (off / on / ``sync``), ``RAMBA_SLOW_FLUSH_FACTOR``,
  ``RAMBA_SLOW_FLUSH_MIN_SAMPLES``, ``RAMBA_PERF_WINDOW`` — the ledger
  (``ledger``'s docstring).
* ``RAMBA_TRACE_BUFFER=<n>`` — pending-line bound of the buffered trace
  writer (default 2048); overflow drops lines and counts
  ``events.write_dropped``.
"""

from ramba_tpu_torch.observe import (  # noqa: F401
    events, health, ledger, observer, registry,
)
