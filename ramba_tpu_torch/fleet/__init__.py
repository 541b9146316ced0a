"""Fleet serving plane: tenant router, replica failover, shared artifacts.

Counterpart of ``ramba_tpu/fleet/``.  The snapshot spool
(``observe/fleet.py``) lets a fleet of replicas see each other; this
package routes, heals and shares:

* :mod:`ramba_tpu_torch.fleet.artifacts` — the **shared artifact tier**:
  one directory (``RAMBA_ARTIFACTS``) behind the result memo's
  content-addressed shared lane and the migration handoffs, with the
  atomic write discipline the persistent kernel cache shares
  (``RAMBA_CACHE``: built libraries and program skeletons).
* :mod:`ramba_tpu_torch.fleet.replica` — a **replica server**: one
  process serving tenant sessions over an authenticated
  ``multiprocessing.connection`` transport, publishing its health into
  the spool, refusing work the way the in-process overload plane does.
* :mod:`ramba_tpu_torch.fleet.router` — the **tenant router**:
  rendezvous-hash affinity, the spool as its health feed, a fleet-level
  circuit breaker per replica, refusals turned into redirects, hedging of
  pure reproducible steps onto a standby, and healing of a dead
  replica's sessions by deterministic step-log replay.
* :mod:`ramba_tpu_torch.fleet.migrate` — **drained-session handoff**
  through the port's checkpoint format: ``export_session`` drains a live
  session, ``adopt_session`` restores it on another replica.

``scripts/fleet_router_torch.py`` serves a replica or drives a router;
``scripts/fleet_collector_torch.py`` reads the spool.
"""

from ramba_tpu_torch.fleet import artifacts, migrate, replica, router  # noqa: F401
from ramba_tpu_torch.fleet.router import (  # noqa: F401
    FleetError,
    NoHealthyReplica,
    ReplicaRefusal,
    ReplicaUnavailable,
    Router,
)
