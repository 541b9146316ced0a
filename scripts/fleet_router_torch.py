#!/usr/bin/env python
"""Fleet serving CLI of ramba_tpu_torch: run a replica server, or drive or
inspect a router.

Three modes:

``--replica``
    Serve this process as one fleet replica: bind an authenticated
    ``multiprocessing.connection`` listener on an ephemeral port, export
    the endpoint into the snapshot spool (``RAMBA_FLEET_DIR``, so the
    router can discover it), and print one marker line::

        REPLICA_READY endpoint=127.0.0.1:45123 replica=host-1234-0

    ``chip_smoke.py`` and the tests parse that line.  Blocks until a
    ``shutdown`` op arrives (or the process is killed: the failure the
    router exists to heal).  Arrays live on the card unless
    ``RAMBA_TORCH_DEVICE=cpu``.

``--status``
    Build a router over the spool and print its replica table, session
    table and counters as JSON; ``--metrics`` prints the router's
    Prometheus exposition instead.

``--demo N``
    Spawn N replica subprocesses, route a short tenant workload across
    them, print the router stats, and shut the fleet down — a smoke test
    of the whole serving plane in one command.

Environment: ``RAMBA_FLEET_DIR`` (spool = discovery), ``RAMBA_ARTIFACTS``
(the shared memo lane and handoffs), ``RAMBA_CACHE`` (the shared kernel
cache), ``RAMBA_FLEET_AUTHKEY``, ``RAMBA_ROUTER_TIMEOUT_S``,
``RAMBA_ROUTER_HEDGE``/``_FACTOR``, ``RAMBA_ROUTER_MAX_REDIRECTS``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_replica(args) -> int:
    from ramba_tpu_torch.fleet.replica import ReplicaServer

    server = ReplicaServer(host=args.host, port=args.port)
    print(f"REPLICA_READY endpoint={server.endpoint} "
          f"replica={server.replica}", flush=True)
    server.serve_forever()
    print(f"REPLICA_EXIT replica={server.replica}", flush=True)
    return 0


def run_status(args) -> int:
    from ramba_tpu_torch.fleet.router import Router

    router = Router(fleet_dir=args.fleet_dir)
    if args.metrics:
        sys.stdout.write(router.metrics_text())
        return 0
    json.dump(router.stats(), sys.stdout, indent=2, default=str)
    print()
    return 0


def start_replica(env_extra=None):
    """Start one replica subprocess without waiting for it: its output
    is drained by a daemon thread into ``proc.lines`` (a queue, read by
    :func:`wait_ready`) and then ``proc.tail`` (its last 50 lines), so a
    long-lived replica never blocks on a full pipe."""
    import collections
    import queue
    import threading

    env = dict(os.environ)
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--replica"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    proc.lines = queue.Queue()
    proc.tail = collections.deque(maxlen=50)

    def drain():
        for line in proc.stdout:
            proc.tail.append(line)
            proc.lines.put(line)
        proc.lines.put(None)

    threading.Thread(target=drain, name="replica-drain",
                     daemon=True).start()
    return proc


def wait_ready(proc, timeout_s: float = 60.0) -> str:
    """The endpoint of a replica started by :func:`start_replica`, once
    its READY marker is printed; the replica is killed and this raises
    when the marker does not come within ``timeout_s``."""
    import queue

    deadline = time.monotonic() + timeout_s
    while True:
        left = deadline - time.monotonic()
        try:
            line = proc.lines.get(timeout=max(0.0, left)) if left > 0 \
                else None
        except queue.Empty:
            line = None
        if line is None:
            proc.kill()
            proc.wait(timeout=10)
            tail = "".join(proc.tail) or "(no output)"
            raise RuntimeError(
                f"replica failed to start within {timeout_s:g} s; output "
                f"tail:\n{tail}")
        if line.startswith("REPLICA_READY"):
            return dict(kv.split("=", 1)
                        for kv in line.split()[1:])["endpoint"]


def spawn_replica(env_extra=None, timeout_s: float = 60.0):
    """Spawn one replica subprocess; returns ``(proc, endpoint)`` after
    the READY marker (used by --demo, ``chip_smoke.py`` and the tests)."""
    proc = start_replica(env_extra)
    return proc, wait_ready(proc, timeout_s)


def run_demo(args) -> int:
    import tempfile

    from ramba_tpu_torch.fleet.router import Router

    base = tempfile.mkdtemp(prefix="ramba-torch-fleet-demo-")
    os.environ["RAMBA_FLEET_DIR"] = os.path.join(base, "spool")
    os.environ["RAMBA_ARTIFACTS"] = os.path.join(base, "artifacts")
    os.environ.setdefault("RAMBA_FLEET_INTERVAL_S", "1")
    os.environ.setdefault("RAMBA_MEMO", "1")
    procs = []
    try:
        endpoints = []
        for _ in range(args.demo):
            proc, ep = spawn_replica()
            procs.append(proc)
            endpoints.append(ep)
        print(f"demo: {len(endpoints)} replica(s): {endpoints}")
        router = Router(endpoints=endpoints)
        for tenant in ("acme", "globex"):
            sid = router.open_session(tenant=tenant)
            router.step(sid, "init", {"name": "x", "shape": [512],
                                      "fill": 2.0, "dtype": "float64"})
            for i in range(4):
                router.step(sid, "affine", {"name": "x", "a": 1.01,
                                            "b": float(i)})
            digest = router.step(sid, "digest")["result"]
            print(f"demo: tenant={tenant} sid={sid[:8]} "
                  f"digest={digest[:16]}…")
            router.close_session(sid)
        json.dump(router.stats(), sys.stdout, indent=2, default=str)
        print()
        router.shutdown_fleet()
        return 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ramba_tpu_torch fleet serving plane: replica server "
                    "+ router driver")
    ap.add_argument("--replica", action="store_true",
                    help="serve this process as one fleet replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (default: ephemeral)")
    ap.add_argument("--status", action="store_true",
                    help="print the router's fleet view as JSON")
    ap.add_argument("--metrics", action="store_true",
                    help="with --status: Prometheus exposition instead")
    ap.add_argument("--fleet-dir", default=None,
                    help="spool directory (default RAMBA_FLEET_DIR)")
    ap.add_argument("--demo", type=int, metavar="N", default=0,
                    help="spawn N replicas, route a demo workload, stop")
    args = ap.parse_args(argv)

    if args.replica:
        return run_replica(args)
    if args.demo:
        return run_demo(args)
    if args.status or args.metrics:
        return run_status(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
