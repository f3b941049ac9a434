"""Copied from serenedb_tpu/sched/__init__.py.

Workload governor subsystem: admission control between statement
dispatch and the shared worker pool, plus the per-statement scheduling
identity (tag + `serene_priority` weight) the pool's fair-share stride
scheduler keys on. See sched/governor.py for the full contract."""

from .governor import (CURRENT_SCHED, GOVERNOR, AdmissionTicket, Governor,
                       admission_exempt, next_stmt_tag)

__all__ = ["CURRENT_SCHED", "GOVERNOR", "AdmissionTicket", "Governor",
           "admission_exempt", "next_stmt_tag"]
