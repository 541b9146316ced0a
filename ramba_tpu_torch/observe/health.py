"""Health event source: bring-up outcomes and healed failures.

Counterpart of ``ramba_tpu/observe/health.py``: explicit health records
(:func:`record`) and the retry engine's recoveries
(:func:`record_recovery`) land in the same event stream as everything
else; :func:`record_mesh` records the first default mesh of the process.
"""

from __future__ import annotations

from typing import Optional

from ramba_tpu_torch.observe import events, registry

_mesh_recorded = False


def record(
    platform: Optional[str] = None,
    device_count: Optional[int] = None,
    init_seconds: Optional[float] = None,
    outcome: str = "ok",
    error: Optional[str] = None,
    selected_via: Optional[str] = None,
    **extra,
) -> dict:
    """Emit one health event.  ``outcome``: "ok" | "fallback" | "error" |
    "recovered".  Returns the emitted event dict."""
    ev = {"type": "health", "outcome": outcome}
    if platform is not None:
        ev["platform"] = platform
    if device_count is not None:
        ev["device_count"] = int(device_count)
    if init_seconds is not None:
        ev["init_seconds"] = round(float(init_seconds), 4)
    if error:
        ev["error"] = str(error)[-800:]
    if selected_via is not None:
        ev["selected_via"] = selected_via
    ev.update(extra)
    registry.inc(f"health.{outcome}")
    return events.emit(ev)


def record_recovery(source: str, retries: int, **extra) -> dict:
    """A transient failure healed after ``retries`` re-attempt(s) — the
    retry engine reports recoveries here so incidents that did NOT become
    hard failures still show up in the health stream."""
    return record(outcome="recovered", source=source,
                  retries=int(retries), **extra)


def record_mesh(mesh, init_seconds: float) -> None:
    """Health record for the first default mesh of each kind (one
    process's, then a mesh of ranks once a group formed)."""
    global _mesh_recorded
    ranks = getattr(mesh, "ranks", None)
    kind = "ranks" if ranks is not None else "one"
    if _mesh_recorded is True or kind in (_mesh_recorded or ()):
        return
    _mesh_recorded = tuple(_mesh_recorded or ()) + (kind,)
    extra = {}
    if ranks is not None:
        extra["ranks"] = ranks.tolist()
    record(
        platform=mesh.device.type,
        device_count=mesh.size,
        init_seconds=init_seconds,
        outcome="ok",
        source="default_mesh",
        mesh_shape={k: int(v) for k, v in mesh.shape.items()},
        **extra,
    )
