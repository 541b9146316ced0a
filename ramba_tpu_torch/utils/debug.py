"""Debug artifacts for the lazy expression graph.

Counterpart of ``ramba_tpu/utils/debug.py``: a graphviz dump of the
pending expression forest (:func:`output_dot`), a report of the arrays
not yet flushed (:func:`report_pending`), the flush statistics written at
exit under ``RAMBA_TPU_HISTORY`` (``ramba_tpu_flush_history.txt`` in the
working directory), and :func:`drain_effect_errors`.
"""

from __future__ import annotations

import atexit
import os
import sys
from typing import Optional

from ramba_tpu_torch.core.expr import Const, Node, Scalar


def _walk(roots):
    """Every expression under ``roots``, each once."""
    seen: dict = {}
    stack = list(roots)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen[id(e)] = e
        if isinstance(e, Node):
            stack.extend(e.args)
    return list(seen.values())


def _label(e) -> str:
    if isinstance(e, Const):
        return f"const {tuple(e.aval.shape)} {e.aval.dtype}"
    if isinstance(e, Scalar):
        return f"scalar {e.value!r}"
    if isinstance(e, Node):
        return f"{e.op} {tuple(e.aval.shape)} {e.aval.dtype}"
    return type(e).__name__


def _pending():
    from ramba_tpu_torch.core import fuser

    return [a for a in fuser._default_stream.pending_roots()
            if not isinstance(a._expr, Const)]


def output_dot(fname: str = "ramba_tpu_graph.dot") -> str:
    """Write the pending expression forest as graphviz dot to ``fname``;
    returns the dot text."""
    nodes = _walk([a._expr for a in _pending()])
    lines = ["digraph ramba_tpu {"]
    for e in nodes:
        shape = "box" if isinstance(e, Node) else "ellipse"
        lines.append(f'  n{id(e)} [label="{_label(e)}", shape={shape}];')
    for e in nodes:
        if isinstance(e, Node):
            for a in e.args:
                lines.append(f"  n{id(a)} -> n{id(e)};")
    lines.append("}")
    text = "\n".join(lines)
    with open(fname, "w") as f:
        f.write(text)
    return text


def report_pending(file=None) -> int:
    """Print the arrays whose graphs have not run yet (sequence number,
    shape, dtype, ops); returns their count."""
    file = file or sys.stderr
    arrs = _pending()
    if not arrs:
        print("no pending lazy arrays", file=file)
        return 0
    print(f"{len(arrs)} pending lazy array(s):", file=file)
    for a in arrs:
        ops = [e.op for e in _walk([a._expr]) if isinstance(e, Node)]
        print(
            f"  seq={a._seq} shape={a.shape} dtype={a.dtype} "
            f"ops={len(ops)} [{', '.join(ops[:8])}"
            f"{'...' if len(ops) > 8 else ''}]",
            file=file,
        )
    return len(arrs)


def drain_effect_errors() -> Optional[Exception]:
    """Wait for the card and return the CUDA error an earlier launch left
    there (None when there is none, and on the CPU).  The reference
    drains jax's runtime-effect tokens here; the port's asynchronous
    failures are CUDA errors, which surface at the next synchronization.
    A sticky error leaves the CUDA context unusable: the process must
    end."""
    import torch

    from ramba_tpu_torch import common

    try:
        dev = common.device()
    except RuntimeError:
        return None
    if dev.type != "cuda":
        return None
    try:
        torch.cuda.synchronize(dev)
    except RuntimeError as e:  # the error is the return value
        return e
    return None


def _dump_history() -> None:
    """Flush statistics and every named counter, written at exit."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.observe import registry

    try:
        with open("ramba_tpu_flush_history.txt", "w") as f:
            for k, v in fuser.stats.items():
                f.write(f"{k}: {v}\n")
            for k in sorted(registry.counters):
                f.write(f"{k}: {registry.counters[k]}\n")
    except OSError:
        pass


if os.environ.get("RAMBA_TPU_HISTORY", "0") not in ("0", ""):
    atexit.register(_dump_history)
