"""Benchmark records: ``config_record`` from ``kubeoperator_tpu/workloads/
costmodel.py``, the one per-config schema the reference's benches share.
The rest of that module (``StepAttribution``, the collective cost model)
belongs to the multi-device slice and is not ported yet;
``attribution`` here takes its ``as_dict()`` form, a plain dict.
"""

from __future__ import annotations


def config_record(*, config: str, n_devices: int, mesh: dict | None = None,
                  step_time_s: float | None = None, mfu: float | None = None,
                  attribution: dict | None = None,
                  compile_counts: dict | None = None, ok: bool = True,
                  error: str | None = None, **extra) -> dict:
    """One benchmark config's structured record. Only measured fields
    appear; ``mesh`` keeps the axes above 1, ``error`` sets ``ok`` false,
    and ``extra`` keys are appended as given."""
    rec: dict = {"config": config, "n_devices": int(n_devices),
                 "ok": bool(ok)}
    if mesh:
        rec["mesh"] = {k: int(v) for k, v in mesh.items() if int(v) > 1}
    if attribution is not None:
        rec.update(dict(attribution))
    if step_time_s is not None:
        rec["step_time_s"] = round(float(step_time_s), 6)
    if mfu is not None:
        rec["mfu"] = round(float(mfu), 6)
    if compile_counts is not None:
        rec["compile_counts"] = compile_counts
    if error is not None:
        rec["ok"] = False
        rec["error"] = str(error)
    rec.update(extra)
    return rec
