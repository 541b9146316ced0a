#!/usr/bin/env python3
"""How a flush's fenced device window of axpy + sum compares with the
same compiled call timed alone, and how the host's state before a call
moves the call's window, on one NVIDIA GPU.

    python3 scripts/fence_probe.py TAG      # from the root of a checkout

Imports the ``ramba_tpu_torch`` of the current directory, so two
checkouts compare by running it from each in turns (A B B A).  It runs
``chip_smoke.py``'s ``observe_path`` (a) order: seven flushes of the
sin/cos chain over a 1e9 float64 base, then axpy + sum over 2^28
float64 (``rt.sum(2.5 * x + y)``) with the fence on, and prints, each
line starting with TAG, in ms:

* ``check``: seven fenced flushes, then five calls of the captured
  compiled call alone under their own CUDA events (after one warm
  call), each p50 and their ratio;
* ``interleaved``: fifteen flushes, the call alone once after each;
* ``alone_sleep_<g>ms`` / ``alone_spin_<g>ms``: nine calls alone, each
  after the host slept or spun g ms (the card idle either way);
* ``flush_sleep_<g>ms``: nine fenced flushes, each after g ms of sleep;
* ``clocks``: the SM and memory clocks and the clock-event reasons that
  ``nvidia-smi`` read every 20 ms during each phase.

Every window is ``start.elapsed_time(end)`` of a pair of CUDA events;
the fenced ones are what ``observe/attrib.py`` records.  Imports nothing
of JAX.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import ramba_tpu_torch as rt  # noqa: E402
from ramba_tpu_torch.core import fuser  # noqa: E402
from ramba_tpu_torch.observe import attrib  # noqa: E402


def p50(v):
    return sorted(v)[len(v) // 2]


def alone(fn, lv, idle_s=0.0, spin=False):
    """One call under its own CUDA events, after ``idle_s`` of host sleep
    (or spin); its window in ms."""
    if idle_s:
        if spin:
            t = time.perf_counter() + idle_s
            while time.perf_counter() < t:
                pass
        else:
            time.sleep(idle_s)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn(*lv)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def clocks_by_phase(path, marks):
    rows = []
    for line in open(path):
        parts = [p.strip() for p in line.split(",")]
        try:
            day, frac = parts[0].split(".")
            ts = time.mktime(time.strptime(day, "%Y/%m/%d %H:%M:%S")) \
                + float("0." + frac)
            rows.append((ts, float(parts[1]), float(parts[2]), parts[5]))
        except (ValueError, IndexError):
            continue
    out = {}
    for (name, t0), (_n, t1) in zip(marks, marks[1:]):
        sel = [r for r in rows if t0 <= r[0] < t1]
        if sel:
            out[name] = {"sm": sorted({r[1] for r in sel}),
                         "mem": sorted({r[2] for r in sel}),
                         "reasons": sorted({r[3] for r in sel}),
                         "n": len(sel)}
    return out


def main(tag: str) -> int:
    rt.set_device("cuda:0")
    fd, smi_path = tempfile.mkstemp(suffix=".csv")
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,clocks.mem,"
         "power.draw,temperature.gpu,clocks_event_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=fd, stderr=subprocess.DEVNULL)
    marks = []
    calls = {}
    orig = fuser._execute_compiled

    def spy(fn, program, leaf_vals, is_new, span, fp, *a, **kw):
        calls[fp] = (fn, list(leaf_vals))
        return orig(fn, program, leaf_vals, is_new, span, fp, *a, **kw)

    dev_ms = []
    real_dev = attrib.record_device

    def rec(fp, label, seconds, backend=None):
        dev_ms.append(seconds * 1e3)
        return real_dev(fp, label, seconds, backend=backend)

    fuser._execute_compiled = spy
    attrib.record_device = rec
    try:
        attrib.reset()
        attrib.reconfigure()
        res = {}
        base = rt.arange(10 ** 9) / 1000.0
        rt.sync()
        for _ in range(7):
            B, C = rt.sin(base), rt.cos(base)
            D = B * B + C * C
            s = rt.sum(D)
            del B, C
            D._value(), s._value()
        del D, s, base
        x = rt.sin(rt.arange(1 << 28) * 1e-3)
        y = rt.cos(rt.arange(1 << 28) * 1e-3)
        rt.sync()
        calls.clear()

        def flush():
            return rt.sum(2.5 * x + y)._value()

        marks.append(("check", time.time()))
        dev_ms.clear()
        for _ in range(7):
            flush()
        fenced = list(dev_ms)
        fn, lv = list(calls.values())[-1]
        alone(fn, lv)
        res["check"] = (fenced, [alone(fn, lv) for _ in range(5)])
        marks.append(("interleaved", time.time()))
        dev_ms.clear()
        own = []
        for _ in range(15):
            flush()
            own.append(alone(fn, lv))
        res["interleaved"] = (list(dev_ms), own)
        for spin in (False, True):
            for gap in (0.0, 0.001, 0.003, 0.010, 0.030):
                key = f"alone_{'spin' if spin else 'sleep'}_{gap * 1e3:g}ms"
                marks.append((key, time.time()))
                res[key] = [alone(fn, lv, gap, spin) for _ in range(9)]
        for gap in (0.0, 0.010):
            key = f"flush_sleep_{gap * 1e3:g}ms"
            marks.append((key, time.time()))
            dev_ms.clear()
            for _ in range(9):
                if gap:
                    time.sleep(gap)
                flush()
            res[key] = list(dev_ms)
        marks.append(("end", time.time()))
        time.sleep(0.1)
    finally:
        fuser._execute_compiled = orig
        attrib.record_device = real_dev
        smi.terminate()
        smi.wait()
        os.close(fd)
    clk = clocks_by_phase(smi_path, marks)
    os.remove(smi_path)
    for k, v in res.items():
        if isinstance(v, tuple):
            f, a = v
            print(tag, k, "fenced p50 %.4f alone p50 %.4f (%+.2f%%)" % (
                p50(f), p50(a), 100 * (p50(f) / p50(a) - 1)),
                [round(t, 4) for t in f], [round(t, 4) for t in a])
        else:
            print(tag, k, "p50 %.4f" % p50(v), [round(t, 4) for t in v])
    print(tag, "clocks", json.dumps(clk))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
