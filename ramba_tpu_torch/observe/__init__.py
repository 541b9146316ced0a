"""Observability for the port.

Counterpart of ``ramba_tpu/observe/``: the event stream (``events``:
in-memory ring, optional JSONL file), the counter registry
(``registry``), the observer-tax ledger (``observer``), health records
(``health``), the kernel cost ledger with its slow-flush sentinel
(``ledger``), flush attribution with CUDA-event fences, rooflines and the
drift sentinel (``attrib``), SLO histograms (``slo``), trace context, the
Prometheus exporter and the flight recorder (``telemetry``) and
``torch.profiler`` hooks (``profile``), and the fleet's snapshot spool
and collector (``fleet``).

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
* ``RAMBA_ATTRIB`` — the device fence of the stage waterfalls and
  rooflines (``attrib``): on by default, ``off``, or ``sample:<N>`` (1
  call in N per kernel fingerprint, by the fingerprint's own counter).
* ``RAMBA_PEAKS_JSON`` — the roofline's peak table (inline JSON or a
  file path).
* ``RAMBA_BASELINE_DIR`` / ``RAMBA_PERF_DRIFT_FACTOR`` /
  ``RAMBA_PERF_DRIFT_MIN_SAMPLES`` — the perf-regression sentinel's
  persisted device-time baselines and its trip point.
* ``RAMBA_SLO_P95_MS`` / ``RAMBA_SLO_MIN_SAMPLES`` — the SLO objective
  and its sample floor (``slo``).
* ``RAMBA_FLIGHT_DIR`` / ``RAMBA_FLIGHT_MAX`` — the flight recorder's
  directory and its per-process file cap (``telemetry``).
* ``RAMBA_METRICS_PORT`` / ``RAMBA_METRICS_HOST`` / ``RAMBA_METRICS_FILE``
  / ``RAMBA_METRICS_INTERVAL_S`` — the Prometheus exporter
  (``telemetry``).
* ``RAMBA_PROFILE_DIR`` — a ``torch.profiler`` trace of the process from
  its first flush, exported at exit; ``RAMBA_PROFILE=deep`` puts the
  span's trace id in each flush range's name (``profile``).
* ``RAMBA_FLEET_DIR`` — the fleet snapshot spool: an atomic versioned
  ``diagnostics.snapshot()`` document at ``<dir>/<host>-<pid>-<rank>.json``
  every ``RAMBA_FLEET_INTERVAL_S`` seconds (default 5); the collector
  (``fleet``, ``scripts/fleet_collector_torch.py``) classifies each replica
  healthy/degraded/stale/dead (``RAMBA_FLEET_STALE_X`` /
  ``RAMBA_FLEET_DEAD_X`` x interval, defaults 1.5 / 2.0).
"""

from ramba_tpu_torch.observe import (  # noqa: F401
    attrib, events, fleet, health, ledger, observer, profile, registry,
    slo, telemetry,
)
