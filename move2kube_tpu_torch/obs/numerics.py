"""Serving numerics knobs of the port: its own copy of ``audit_rate``
from ``move2kube_tpu/obs/numerics.py``. The tensor-health recorder and
the tree summaries of that module are not ported yet (ROADMAP.md,
Queue 1 item 7)."""

from __future__ import annotations

import os


def audit_rate(env=None) -> float:
    """Serving quant-drift audit rate (``M2KT_QUANT_AUDIT_RATE``):
    fraction of cold admissions re-run through the fp reference path.
    0 (the default) disables the auditor and keeps no fp weight copy."""
    env = os.environ if env is None else env
    try:
        rate = float(env.get("M2KT_QUANT_AUDIT_RATE", "") or 0.0)
    except ValueError:
        return 0.0
    return min(1.0, max(0.0, rate))
